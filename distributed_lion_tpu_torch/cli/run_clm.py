"""Causal-LM pretraining entry point: port of ``distributed_lion_tpu/cli/run_clm.py``.

The reference's canonical launch, one process per GPU:

    torchrun --nproc_per_node 4 -m distributed_lion_tpu_torch.cli.run_clm \\
        --lion --async_grad --model_name gpt2_124m --dataset synthetic \\
        --per_device_train_batch_size 20 --gradient_accumulation_steps 8 \\
        --learning_rate 1e-4 --weight_decay 0.1 --warmup_steps 2000 \\
        --max_steps 100000 --block_size 1024 --output_dir ./out

Without torchrun it trains a world of one. It runs on the GPU;
``DLION_PLATFORM=cpu`` asks for the CPU (gloo under torchrun). Datasets:
``synthetic``, ``text:<glob>`` (local text through ``--tokenizer_name``:
bytes, or GPT-2 BPE with ``bpe:<dir>``; the embedding grows to the
tokenizer's vocabulary unless ``--vocab_size`` is set) and ``bin:<glob>``
(pre-tokenized uint16/uint32 shards, read by the C++ mmap and prefetch
loader, ``data/native_loader.py``, unless ``--native_loader false`` or no
C++ compiler is found). With ``--output_dir`` the trainer checkpoints every
``--save_steps`` into ``output_dir/checkpoints`` and resumes from there
(``train/loop.py``); a run that ends saves its last step, and rank 0 writes
``output_dir/model.npz`` in the JAX package's format (the GPT-2 params or
the Llama weight tree). ``--model_family llama`` trains every parameter of
a Llama from a seeded init (``--model_name tiny | small | llama2_7b |
llama3_8b``; no dropout, so ``--dropout`` > 0 is refused, and
``--vocab_pad_multiple`` is GPT-2's). ``--vocab_chunks N`` streams either
family's head through the chunked-vocabulary cross entropy
(``ops/xent.py``). ``--model_path`` starts from a local Hugging Face
checkpoint (``models/hf_import.py``): the family is the checkpoint's, its
architecture cannot be overridden (``--vocab_size``, ``--n_ctx``), the
embedding does not grow to a ``text:`` tokenizer, and GPT-2's table is
padded to ``--vocab_pad_multiple`` with zero rows. ``--hf_export <dir>``
writes the final weights as an HF ``save_pretrained`` directory with the
tokenizer's files and a model card (``models/hf_export.py``, rank 0).

``--tensor_parallel tp`` (it must divide ``WORLD_SIZE``) splits either
family over tensor groups of tp consecutive ranks (``parallel/mesh.py``: rank
``r`` is data rank ``r // tp``, tensor rank ``r % tp``), Megatron-style
(``parallel/tensor_parallel.py``), and the vote runs over each data group;
``--tp_vocab`` splits the embedding (GPT-2, padded by
``--vocab_pad_multiple``) or the ``lm_head`` (Llama) by vocabulary too and
takes the vocab-parallel loss (JAX run_clm.py:114-132, 327-342). ``model.npz``,
``--hf_export`` and the checkpoints hold the whole leaves. ``--seq_parallel
sp`` splits every row's tokens over seq groups of sp consecutive ranks
(``parallel/mesh.py``: rank ``r = (d·tp + t)·sp + s``), either family, with
or without ``--tensor_parallel``: attention rings the k/v blocks over the
group (``--seq_impl ring``) or swaps tokens for heads with two all-to-alls
(``--seq_impl ulysses``, n_head % sp == 0), the loss takes a chunk's last
label from the next chunk, and the trainer sums the gradient over the group
(``parallel/ring_attention.py``, ``train/loop.py``). GPT-2's default
dropout is 0 under it (an explicit ``--dropout`` keeps residual and
embedding dropout only; the trainer warns). ``--remat_policy dots`` keeps
the outputs of the products without batch dims in each rematerialized block
(``models.gpt2.remat``; JAX run_clm.py:62-72, 347-349). ``--moe_experts E``
makes every ``--moe_every``-th GPT-2 block's MLP a Switch-MoE FFN of E
experts at ``--moe_capacity_factor`` (``parallel/expert.py``), and
``--expert_parallel ep`` (it must divide E and ``WORLD_SIZE``) splits the
experts, and each data rank's batch rows, over expert groups of ep
consecutive ranks (``parallel/mesh.py``: rank ``r = ((d·tp + t)·sp + s)·ep
+ e``), composing with ``--tensor_parallel``; ``--ep_dcn_pipeline`` 0 feeds
the balance loss the load summed over the expert group in the forward, d >
0 the load of d steps before (``train/loop.py``). Llama and ``--hf_export``
refuse MoE (JAX run_clm.py:355-363, 431-435). ``--pipeline_parallel pp``
splits either family's blocks into pp stages over pipe groups
(``parallel/mesh.py``: rank ``r = (((d·tp + t)·sp + s)·pp + p)·ep + e``),
each rank's batch cut into ``--pipeline_microbatches`` (0: pp) GPipe
microbatches (``parallel/pipeline.py``, ``models/gpt2_pipe.py``,
``models/llama_pipe.py``), composing with ``--tensor_parallel`` and
``--seq_parallel``; GPT-2's default dropout is 0 under it, and an explicit
one is refused (JAX run_clm.py:82-96). ``model.npz`` and ``--hf_export``
hold the whole model, every stage's blocks (JAX :525-537).
"""

from __future__ import annotations

import dataclasses
import glob
from typing import Optional

import numpy as np
import torch

from distributed_lion_tpu_torch.data.sources import (
    TokenDataset,
    batch_iterator,
    synthetic_lm_dataset,
    tokens_from_text_files,
)
from distributed_lion_tpu_torch.data.tokenizer import load_tokenizer
from distributed_lion_tpu_torch.models import hf_export, hf_import
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config, pad_wte
from distributed_lion_tpu_torch.models.llama import LlamaConfig
from distributed_lion_tpu_torch.parallel.mesh import (
    init_distributed,
    make_grid,
    platform_device,
)
from distributed_lion_tpu_torch.train.loop import (
    TrainConfig,
    Trainer,
    announce_guards,
    report_preempted,
)
from distributed_lion_tpu_torch.utils.argparsing import parse_dataclasses
from distributed_lion_tpu_torch.utils.serialization import (
    llama_params_to_jax,
    params_to_jax,
    save_pytree,
    state_dict_from_tree,
    tree_from_state_dict,
)


@dataclasses.dataclass
class ModelArguments:
    model_family: str = "gpt2"  # gpt2 | llama
    model_name: str = "gpt2_124m"  # gpt2: gpt2_124m | gpt2_small | tiny;
    # llama: tiny | small | llama2_7b | llama3_8b
    model_path: Optional[str] = None  # a local HF checkpoint to start from
    hf_export: Optional[str] = None   # write an HF save_pretrained directory here
    vocab_size: Optional[int] = None
    n_ctx: Optional[int] = None
    dropout: Optional[float] = None  # None = family default: 0.1 for GPT-2 (0 under
    # --seq_parallel and --pipeline_parallel), 0 for Llama
    seq_impl: str = "ring"  # under --seq_parallel: ring | ulysses (n_head % sp == 0)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"  # full (recompute the whole block) | dots (keep the products)
    vocab_pad_multiple: int = 0
    moe_experts: int = 0  # > 0: Switch-MoE FFN every moe_every-th block (GPT-2)
    moe_every: int = 2
    moe_capacity_factor: float = 1.25


def resolve_dropout(dropout: Optional[float], family: str, pp: int = 1, sp: int = 1) -> float:
    """0.1 for GPT-2 when unset, the HF GPT-2 config's every pdrop; 0 under
    pipeline parallelism, where dropout is refused (an explicit value still
    fails there), and under sequence parallelism, which skips
    attention-probability dropout (JAX run_clm.py:80-97)."""
    if dropout is not None:
        return dropout
    return 0.1 if family == "gpt2" and pp <= 1 and sp <= 1 else 0.0


@dataclasses.dataclass
class DataArguments:
    dataset: str = "synthetic"  # synthetic | text:<glob> | bin:<glob>
    tokenizer_name: Optional[str] = None  # text: only; see data/tokenizer.load_tokenizer
    validation_split_percentage: int = 5
    max_train_samples: Optional[int] = None
    max_eval_samples: Optional[int] = None
    synthetic_blocks: int = 4096
    native_loader: bool = True  # the C++ mmap + prefetch loader for bin: datasets
    bin_dtype: str = "uint16"


VOCAB_PROBE_TOKENS = 4_000_000  # sample budget for the token-id range check


def _check_vocab(max_token_id: int, vocab_size: int) -> None:
    # an id past the embedding table would index out of range
    if max_token_id >= vocab_size:
        raise ValueError(
            f"dataset contains token id {max_token_id} >= model vocab_size {vocab_size}; "
            "set --vocab_size (or use a matching tokenizer)")


def _bin_paths(spec: str) -> list:
    paths = sorted(glob.glob(spec[len("bin:"):]))
    if not paths:
        raise FileNotFoundError(f"no files match {spec!r}")
    return paths


def load_blocks(data_args: DataArguments, block_size: int, vocab_size: int):
    """(train, eval) int32 block arrays, split and truncated as the JAX
    package's ``load_blocks``."""
    if data_args.dataset == "synthetic":
        blocks = synthetic_lm_dataset(data_args.synthetic_blocks, block_size, vocab_size)
    elif data_args.dataset.startswith("text:"):
        paths = sorted(glob.glob(data_args.dataset[len("text:"):]))
        if not paths:
            raise FileNotFoundError(f"no files match {data_args.dataset!r}")
        blocks = tokens_from_text_files(paths, block_size, data_args.tokenizer_name)
    elif data_args.dataset.startswith("bin:"):
        # each shard cut on its own (its tail below one block dropped), the
        # native loader's layout
        shards = [TokenDataset.from_bin(p, block_size, np.dtype(data_args.bin_dtype)).blocks
                  for p in _bin_paths(data_args.dataset)]
        blocks = np.concatenate([s for s in shards if len(s)])
    else:
        raise ValueError(f"unknown dataset spec {data_args.dataset!r}")
    if len(blocks):
        sample = np.asarray(blocks[: max(1, VOCAB_PROBE_TOKENS // blocks.shape[1])])
        _check_vocab(int(sample.max()), vocab_size)
    n_val = max(1, len(blocks) * data_args.validation_split_percentage // 100)
    train, val = blocks[n_val:], blocks[:n_val]
    if data_args.max_train_samples:
        train = train[: data_args.max_train_samples]
    if data_args.max_eval_samples:
        val = val[: data_args.max_eval_samples]
    return np.asarray(train), np.asarray(val)


def make_native_pipeline(data_args: DataArguments, block_size: int, vocab_size: int,
                         global_batch: int, seed: int):
    """The C++ mmap + prefetch pipeline of a ``bin:<glob>`` dataset:
    ``(train_iter, eval_blocks, loader)``, or None for the Python path
    (another dataset, ``--native_loader false``, or no C++ compiler). The
    hold-out is always the full split percentage, so the training blocks
    are those of :func:`load_blocks`."""
    if not (data_args.dataset.startswith("bin:") and data_args.native_loader):
        return None
    from distributed_lion_tpu_torch.data.native_loader import NativeTokenLoader, native_available

    if not native_available():
        print("[run_clm] no C++ toolchain; falling back to Python loader")
        return None
    paths = _bin_paths(data_args.dataset)
    loader = NativeTokenLoader(paths, block_size, dtype=np.dtype(data_args.bin_dtype))
    n = len(loader)
    n_val = max(1, n * data_args.validation_split_percentage // 100)
    hi = n
    if data_args.max_train_samples:
        hi = min(n, n_val + data_args.max_train_samples)
    if data_args.max_eval_samples:
        n_eval_read = min(n_val, data_args.max_eval_samples)
    else:
        n_eval_read = min(n_val, 4096)
        if n_eval_read < n_val:
            print(f"[run_clm] eval uses the first {n_eval_read} of {n_val} held-out blocks "
                  "(set --max_eval_samples to override)")
    eval_blocks = loader.read_blocks(0, n_eval_read)
    # the vocabulary probe samples the train range too
    n_probe = max(1, min(hi - n_val, VOCAB_PROBE_TOKENS // block_size))
    probe_idx = np.linspace(n_val, hi - 1, n_probe, dtype=np.int64)
    mx = max(int(eval_blocks.max()) if n_eval_read else 0,
             max(int(loader.read_block(int(i)).max()) for i in probe_idx))
    _check_vocab(mx, vocab_size)
    it = loader.batches(global_batch, seed=seed, block_range=(n_val, hi))
    print(f"[run_clm] native loader: {len(paths)} shard(s), {n} blocks ({n_val} held out for "
          "eval)")
    return it, eval_blocks, loader


def check_shard_fleet(trainer: Trainer, loader) -> None:
    """Stamp the served shards into the checkpoints' meta, and refuse a
    resume whose fleet differs from the checkpoint's: block indices are a
    function of the fleet, so the resumed data would not be the run's."""
    trainer.data_meta["data_shards"] = loader.shards
    if trainer.step_count == 0:
        return
    ck = trainer.checkpointer
    meta = (ck.manifest_meta(trainer.step_count) if ck and trainer.cfg.ckpt_integrity
            else None) or {}
    old = meta.get("data_shards")
    if old is not None and list(old) != list(loader.shards):
        raise RuntimeError(
            f"resuming from step {trainer.step_count} but the served shard fleet changed: the "
            f"checkpoint recorded {old}, this run would serve {loader.shards} (skipped: "
            f"{loader.skipped_shards}). Restore the original shards, or start fresh with "
            "--resume_from_checkpoint false or another --output_dir")
    if old is None and loader.skipped_shards:
        raise RuntimeError(
            f"resuming from step {trainer.step_count} but {len(loader.skipped_shards)} "
            f"shard(s) failed to load ({loader.skipped_shards}) and the checkpoint records no "
            "shard fleet. Restore the shard(s), or start fresh with "
            "--resume_from_checkpoint false or another --output_dir")


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def config_args(model_args: ModelArguments) -> dict:
    """``param_dtype``, ``compute_dtype``, ``remat``, ``remat_policy`` and
    ``seq_impl``: the config fields of either family the flags set."""
    return dict(param_dtype=DTYPES[model_args.param_dtype],
                compute_dtype=DTYPES[model_args.compute_dtype], remat=model_args.remat,
                remat_policy=model_args.remat_policy, seq_impl=model_args.seq_impl)


def check_family(model_args: ModelArguments, family: str, ep: int = 1) -> None:
    """The JAX CLI's family guards (run_clm.py:355-370), judged on the
    family that will run (``ep`` the expert axis)."""
    if family not in ("gpt2", "llama"):
        raise ValueError(f"unknown model family {family!r}")
    if family == "llama" and (model_args.moe_experts > 0 or ep > 1):
        raise NotImplementedError(
            "--model_family llama composes with dp x tp x sp x pp; MoE and "
            "the expert axis are wired for GPT-2 only")
    if family == "llama" and (model_args.dropout or 0.0) > 0.0:
        raise ValueError("our Llama (like HF's) has no dropout; set --dropout 0")
    if family == "llama" and model_args.vocab_pad_multiple:
        raise ValueError("--vocab_pad_multiple is a GPT-2 layout option; Llama vocabs "
                         "(32000/128256) are already 128-multiples")


def model_config(model_args: ModelArguments, sp: int = 1, ep: int = 1, pp: int = 1):
    """The ``GPT2Config`` or ``LlamaConfig`` of a seeded init, with the JAX
    CLI's family guards."""
    family = model_args.model_family
    check_family(model_args, family, ep)
    common = config_args(model_args)
    if family == "llama":
        cfg = LlamaConfig.named(model_args.model_name, **common)
    else:
        presets = {"tiny": GPT2Config.tiny, "gpt2_small": GPT2Config.small,
                   "gpt2_124m": GPT2Config.gpt2_124m}
        if model_args.model_name not in presets:
            raise ValueError(f"unknown gpt2 model_name {model_args.model_name!r}")
        cfg = presets[model_args.model_name](
            dropout=resolve_dropout(model_args.dropout, family, pp, sp),
            vocab_pad_multiple=model_args.vocab_pad_multiple,
            moe_experts=model_args.moe_experts, moe_every=model_args.moe_every,
            moe_capacity_factor=model_args.moe_capacity_factor, **common)
    if model_args.vocab_size:
        cfg = dataclasses.replace(cfg, vocab_size=model_args.vocab_size)
    if model_args.n_ctx:
        cfg = dataclasses.replace(cfg, n_ctx=model_args.n_ctx)
    return cfg


def load_pretrained(model_args: ModelArguments, device, announce: bool = True,
                    sp: int = 1, ep: int = 1, pp: int = 1) -> tuple:
    """``--model_path``: ``(initial weight tree on device, config)`` of the
    checkpoint, its family detected first (JAX run_clm.py:331-339,
    372-398, 415); GPT-2's table padded to ``--vocab_pad_multiple``."""
    path = model_args.model_path
    family = hf_import.detect_family(path)
    if family != model_args.model_family and announce:
        print(f"[run_clm] --model_family {model_args.model_family} -> {family} "
              "(detected from --model_path)")
    check_family(model_args, family, ep)
    if family == "llama":
        params, cfg = hf_import.llama_from_hf(path, device=device, **config_args(model_args))
    else:
        params, cfg = hf_import.gpt2_from_hf(
            path, device=device, dropout=resolve_dropout(model_args.dropout, family, pp, sp),
            **config_args(model_args))
    if announce:
        print(f"[run_clm] loaded pretrained {family} from {path}: {cfg.n_layer}L "
              f"d={cfg.d_model} vocab={cfg.vocab_size}")
    if model_args.vocab_pad_multiple:
        # zero alignment rows; the HF export slices them back off
        cfg = dataclasses.replace(cfg, vocab_pad_multiple=model_args.vocab_pad_multiple)
        params["wte"] = pad_wte(params["wte"], cfg)
    if model_args.vocab_size or model_args.n_ctx:
        raise ValueError("--vocab_size/--n_ctx cannot override a loaded checkpoint's "
                         "architecture")
    return params, cfg


def export_hf(trainer: Trainer, whole: dict, model_args: ModelArguments,
              data_args: DataArguments, train_cfg: TrainConfig) -> None:
    """``--hf_export``: the final weights (``whole``, ``Trainer.full_named``)
    as an HF directory, the tokenizer's files beside them and a model card
    with the JAX CLI's summary keys (run_clm.py:544-577)."""
    model_cfg = trainer.model.cfg
    llama = isinstance(model_cfg, LlamaConfig)
    family = "llama" if llama else "gpt2"
    path = model_args.hf_export
    if llama:
        hf_export.llama_to_hf(tree_from_state_dict(whole), model_cfg, path)
    else:
        hf_export.gpt2_to_hf(tree_from_state_dict(whole), model_cfg, path)
    hf_export.copy_tokenizer_files(data_args.tokenizer_name, path)
    hf_export.write_model_card(path, model_type=family, train_summary={
        "optimizer": "distributed-lion" if train_cfg.lion else "adamw",
        "async_grad": train_cfg.async_grad,
        "wire": trainer.cfg.wire,   # what ran, not the 'auto' sentinel
        "vote_every": trainer.cfg.vote_every,
        "steps": train_cfg.max_steps,
        "learning_rate": train_cfg.learning_rate,
        "weight_decay": train_cfg.weight_decay,
        "global_batch": trainer.global_train_batch(),
        "block_size": train_cfg.block_size,
        "n_params": trainer.n_global,
    })
    print(f"[run_clm] HF-format checkpoint at {path}")


def main(argv=None) -> Trainer:
    """Train, evaluate, save the last step and write
    ``output_dir/model.npz`` (and ``--hf_export``); returns the (closed) trainer, whose
    ``history`` holds the logged rows (with the native loader's
    ``skipped_shards`` and ``shard_read_retries`` where it served the
    batches)."""
    model_args, data_args, train_cfg = parse_dataclasses(
        (ModelArguments, DataArguments, TrainConfig), argv)
    device = platform_device()
    group = init_distributed(device)
    grid = make_grid(train_cfg.tensor_parallel, group, sp=train_cfg.seq_parallel,
                     ep=train_cfg.expert_parallel, pp=train_cfg.pipeline_parallel)
    rank0 = grid.rank == 0
    initial_params = None
    if model_args.model_path:
        initial_params, model_cfg = load_pretrained(model_args, device, announce=rank0,
                                                    sp=grid.sp, ep=grid.ep, pp=grid.pp)
    else:
        model_cfg = model_config(model_args, grid.sp, grid.ep, grid.pp)
    if (initial_params is None and not model_args.vocab_size
            and data_args.dataset.startswith("text:")):
        # (a loaded checkpoint's embedding is fixed: out-of-range tokenizer
        # ids are caught by the vocabulary probe instead)
        tok_vocab = load_tokenizer(data_args.tokenizer_name).vocab_size
        if tok_vocab > model_cfg.vocab_size:
            print(f"[run_clm] growing vocab_size {model_cfg.vocab_size} -> tokenizer {tok_vocab}")
            model_cfg = dataclasses.replace(model_cfg, vocab_size=tok_vocab)
    if model_args.hf_export and getattr(model_cfg, "moe_experts", 0) > 0:
        # refused before the training budget is spent: an MoE block has no
        # HF GPT-2 equivalent
        raise ValueError("--hf_export is incompatible with --moe_experts: "
                         "MoE blocks have no HF GPT-2 equivalent")
    if train_cfg.block_size > model_cfg.n_ctx:
        print(f"[run_clm] capping block_size {train_cfg.block_size} -> n_ctx {model_cfg.n_ctx}")
        train_cfg.block_size = model_cfg.n_ctx
    llama = isinstance(model_cfg, LlamaConfig)
    if llama:
        trainer = Trainer.for_llama(train_cfg, model_cfg, device=device,
                                    initial_params=initial_params, grid=grid)
    else:
        trainer = Trainer.for_gpt2(
            train_cfg, model_cfg, device=device, grid=grid,
            initial_params=None if initial_params is None else state_dict_from_tree(
                initial_params))
    del initial_params
    if train_cfg.telemetry and rank0:
        # only the tally wires carry exact margins; the ±1-proxy wire zeroes
        # the histogram by design (train/telemetry.tally_wire)
        print("[run_clm] vote-health telemetry on: margin histogram "
              + ("EXACT (tally wire " if trainer.margin_exact else "UNAVAILABLE (proxy wire ")
              + f"{trainer.cfg.wire}); drained every {train_cfg.logging_steps} steps")
    announce_guards(trainer, "run_clm")
    loader = None
    try:
        native = make_native_pipeline(data_args, train_cfg.block_size, model_cfg.vocab_size,
                                      trainer.global_train_batch(), train_cfg.seed)
        if native is not None:
            it, eval_blocks, loader = native
            check_shard_fleet(trainer, loader)
        else:
            train_blocks, eval_blocks = load_blocks(data_args, train_cfg.block_size,
                                                    model_cfg.vocab_size)
            it = batch_iterator(train_blocks, trainer.global_train_batch(),
                                seed=train_cfg.seed)
        trainer.train(it, eval_blocks=eval_blocks)
        if report_preempted(trainer, "run_clm"):
            return trainer
        if len(eval_blocks):
            trainer.evaluate(eval_blocks)
        if trainer.checkpointer:
            trainer.save()
        if (train_cfg.output_dir or model_args.hf_export) and trainer.rank == 0:
            # data rank 0's tensor, expert and pipe groups gather the whole
            # leaves (every stage's blocks); rank 0 writes
            whole = trainer.full_named()
            if train_cfg.output_dir and rank0:
                save_pytree(f"{train_cfg.output_dir}/model.npz",
                            llama_params_to_jax(tree_from_state_dict(whole)) if llama
                            else params_to_jax(whole))
            if model_args.hf_export and rank0:
                export_hf(trainer, whole, model_args, data_args, train_cfg)
    finally:
        trainer.close()
        if loader is not None:
            loader.close()
    return trainer


if __name__ == "__main__":
    main()
