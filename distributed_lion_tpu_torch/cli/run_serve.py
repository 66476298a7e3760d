"""Serving entry point: port of ``distributed_lion_tpu/cli/run_serve.py``.

Continuous batching over a paged KV cache (``serve/engine.py``). It loads
the checkpoints ``run_generate`` loads (a JAX ``model.npz``, a training
``--output_dir``, an HF ``save_pretrained`` directory, the family detected;
a random init from ``--seed`` without ``--model_path``) and drains a
request file (``serve/api.py``'s schema)::

    python -m distributed_lion_tpu_torch.cli.run_serve \\
        --model_path ./out --model_family gpt2 --model_name tiny \\
        --requests requests.jsonl --out responses.jsonl \\
        --quant nf4 --max_seqs 32 --block_size 16

Without ``--requests`` the ``--prompt`` strings are the workload (a smoke
mode, one JSON line a prompt). ``--prefix_cache`` shares prompt-prefix
pages with copy-on-write; ``--journal_dir`` records the ``serve/*`` spans;
``--serve_metrics`` arms the metrics plane and ``--slo_ttft_ms``,
``--slo_tok_ms``, ``--slo_p99`` the SLO monitor (tokens unchanged by
either). It runs on the GPU; ``DLION_PLATFORM=cpu`` asks for the CPU.

Refused by name when set away from their defaults: ``--serve_tp``,
``--serve_ep``, ``--serve_ep_batch``, ``--serve_ep_overlap``, ``--speculate``
and ``--draft_model_*`` (ROADMAP Queue 1 item 12(d)); the fleet's
``--replicas``, ``--inject_serve``, ``--listen``, ``--listen_wall_s``,
``--replica_procs``, ``--heartbeat_timeout_s``, ``--heartbeat_max_misses``,
``--fleet_state_dir``, ``--fleet_persist_every`` and ``--resume_fleet``
(item 12(e)).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class ServeArguments:
    requests: Optional[str] = None   # request JSONL (serve/api schema); unset: the
    # --prompt strings. Sampling and --max_new_tokens ride GenerateArguments
    out: Optional[str] = None        # response JSONL (default stdout)
    max_seqs: int = 8
    block_size: int = 16
    max_blocks_per_seq: int = 8
    num_blocks: int = 0              # 0 = max_seqs * max_blocks_per_seq
    prefill_cap_tokens: int = 512
    quant: str = "none"              # none | nf4 | int8 (ops/quant)
    quant_block: Optional[int] = None  # quant block override
    serve_tp: int = 0                # tensor-parallel serving: Queue 1 item 12(d)
    serve_ep: int = 0                # expert-parallel serving: item 12(d)
    serve_ep_batch: bool = False     # batch-sharded expert serving: item 12(d)
    serve_ep_overlap: bool = False   # two-microbatch decode tick: item 12(d)
    prefix_cache: bool = False       # share prompt-prefix KV pages (copy-on-write)
    serve_retrace_guard: str = "warn"  # off | warn | error (serve/engine.py)
    speculate: str = ""              # speculative decode: item 12(d)
    draft_model_path: Optional[str] = None   # the draft model: item 12(d)
    draft_model_name: Optional[str] = None
    listen: str = ""                 # the socket transport: item 12(e)
    listen_wall_s: float = 0.0       # the fleet's options: item 12(e)
    replica_procs: bool = False      # process replicas: item 12(e)
    heartbeat_timeout_s: float = 60.0
    heartbeat_max_misses: int = 3
    fleet_state_dir: Optional[str] = None  # fleet persistence: item 12(e)
    fleet_persist_every: int = 0
    resume_fleet: bool = False
    replicas: int = 1                # > 1: the elastic fleet, item 12(e)
    inject_serve: str = ""           # the fleet's fault schedule: item 12(e)
    serve_metrics: bool = False      # the metrics plane (serve/metrics.ServeMetrics)
    slo_ttft_ms: Optional[float] = None   # SLO on time to first token (wall ms)
    slo_tok_ms: Optional[float] = None    # SLO on mean decode ms a token
    slo_p99: float = 0.99            # error budget 1 - slo_p99
    journal_dir: Optional[str] = None


# flags of parts still to port: a value other than the default is refused
ITEM_D_FLAGS = ("serve_tp", "serve_ep", "serve_ep_batch", "serve_ep_overlap", "speculate",
                "draft_model_path", "draft_model_name")
ITEM_E_FLAGS = ("replicas", "inject_serve", "listen", "listen_wall_s", "replica_procs",
                "heartbeat_timeout_s", "heartbeat_max_misses", "fleet_state_dir",
                "fleet_persist_every", "resume_fleet")


def refuse_unported(args: ServeArguments) -> None:
    """Raise ``NotImplementedError`` naming the first flag set away from its
    default that the port does not serve yet, and its ROADMAP item."""
    from distributed_lion_tpu_torch.serve.unported import ITEM_D, ITEM_E, refuse

    defaults = ServeArguments()
    for item, names in ((ITEM_D, ITEM_D_FLAGS), (ITEM_E, ITEM_E_FLAGS)):
        refuse(item, {f"--{n}": getattr(args, n) for n in names},
               {f"--{n}": getattr(defaults, n) for n in names})


def build_engine_factory(gen_args, serve_args: ServeArguments, device=None):
    """``(tokenizer, factory)``: the checkpoint loads once
    (``cli.run_generate.build``) and ``factory()`` builds a fresh
    :class:`~distributed_lion_tpu_torch.serve.engine.ServingEngine` over the
    shared weights, its own page pool and tables each call."""
    from distributed_lion_tpu_torch.cli.run_generate import build
    from distributed_lion_tpu_torch.serve.engine import ServeConfig, ServeModel, ServingEngine
    from distributed_lion_tpu_torch.serve.metrics import ServeMetrics, SLOMonitor

    refuse_unported(serve_args)
    tok, cfg, params, _, _ = build(gen_args, device)
    model = (ServeModel.for_gpt2(params, cfg) if gen_args.model_family == "gpt2"
             else ServeModel.for_llama(params, cfg))
    slo_armed = serve_args.slo_ttft_ms is not None or serve_args.slo_tok_ms is not None
    scfg = ServeConfig(
        max_seqs=serve_args.max_seqs, block_size=serve_args.block_size,
        max_blocks_per_seq=serve_args.max_blocks_per_seq, num_blocks=serve_args.num_blocks,
        prefill_cap_tokens=serve_args.prefill_cap_tokens,
        max_new_tokens=gen_args.max_new_tokens, temperature=gen_args.temperature,
        top_k=gen_args.top_k, top_p=gen_args.top_p, quant=serve_args.quant,
        quant_block=serve_args.quant_block, prefix_cache=serve_args.prefix_cache,
        retrace_guard=serve_args.serve_retrace_guard,
        metrics=serve_args.serve_metrics or slo_armed, eos_id=getattr(tok, "eos_id", None))

    def factory() -> ServingEngine:
        engine = ServingEngine(model, scfg)
        if slo_armed:
            engine.metrics = ServeMetrics(
                engine.times, slo=SLOMonitor(ttft_ms=serve_args.slo_ttft_ms,
                                             tok_ms=serve_args.slo_tok_ms,
                                             p99=serve_args.slo_p99))
        return engine

    return tok, factory


def build_engine(gen_args, serve_args: ServeArguments, device=None):
    """``(tokenizer, engine)``: the single-engine surface of this CLI and the
    tests."""
    tok, factory = build_engine_factory(gen_args, serve_args, device)
    return tok, factory()


def main(argv=None):
    from distributed_lion_tpu_torch.cli.run_generate import GenerateArguments
    from distributed_lion_tpu_torch.parallel.mesh import platform_device
    from distributed_lion_tpu_torch.serve import api
    from distributed_lion_tpu_torch.serve.engine import Request
    from distributed_lion_tpu_torch.train import journal as journal_mod
    from distributed_lion_tpu_torch.utils.argparsing import parse_dataclasses

    gen_args, args = parse_dataclasses((GenerateArguments, ServeArguments), argv)
    refuse_unported(args)   # before the device is resolved
    jrnl = None
    if args.journal_dir:
        jrnl = journal_mod.Journal(args.journal_dir)
        journal_mod.install(jrnl)
    try:
        tok, engine = build_engine(gen_args, args, platform_device())
        if args.requests:
            records = api.serve_request_file(engine, args.requests, args.out or "/dev/stdout",
                                             tok)
        else:
            prompts = list(gen_args.prompt) or ["Hello"]
            reqs = [Request(req_id=f"req{i}", tokens=tok.encode(p, add_bos=False) or [0],
                            max_new_tokens=gen_args.max_new_tokens, seed=gen_args.seed)
                    for i, p in enumerate(prompts)]
            records = api.handle_requests(engine, reqs, tokenizer=tok)
            for p, rec in zip(prompts, records):
                print(json.dumps({"prompt": p, **rec}, allow_nan=False), flush=True)
        journal_mod.active().event("serve_done", **{
            k: (float(v) if isinstance(v, float) else int(v)) for k, v in engine.stats.items()})
        if engine.metrics is not None:
            # the end-of-run snapshot, even when the run was shorter than a drain
            engine.metrics.drain(engine.stats["ticks"])
        return records
    finally:
        if jrnl is not None:
            journal_mod.uninstall(jrnl)
            jrnl.close()


if __name__ == "__main__":
    main()
