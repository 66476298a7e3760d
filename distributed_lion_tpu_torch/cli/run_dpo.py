"""DPO entry point: port of ``distributed_lion_tpu/cli/run_dpo.py``, the intended workload of the reference's ``dpo_llama2.py``.

    python -m distributed_lion_tpu_torch.cli.run_dpo --lion --async_grad \\
        --model_name llama2_7b --quant_ref nf4 --attn_impl flash \\
        --per_device_train_batch_size 2 --gradient_accumulation_steps 2 \\
        --max_steps 100 --output_dir ./dpo

The reference's file does not parse (a syntax error at :81, ``base_model``
undefined at :210-213); the JAX package implements what it meant, and so
does this port:

- a policy and a frozen reference, both starting from the SFT model
  (``--sft_checkpoint``, a merged ``.npz`` that ``run_sft
  --merged_output`` writes, float leaves cast to the param dtype), else
  from a local Hugging Face Llama checkpoint (``--model_path``,
  ``models/hf_import.py``, which also gives the architecture), else from a
  fresh init of ``--seed``. The policy's base stays dense; the
  reference is the same tensors at ``--quant_ref none`` and a quantized copy
  at ``int8`` or ``nf4`` (the reference repo's 4-bit reference model);
- the β 0.1 pairwise loss (``train/dpo.py``) over prompt/chosen/rejected
  rows, length-filtered and masked to the completion (``data/dpo.py``);
  ``--max_length`` is clamped to the model's context, and the eval split
  is ``min(size_valid_set, n // 4)`` pairs;
- LoRA on the policy over the reference's wider target set
  (``models.lora.DPO_TARGET_PATTERNS``: the four attention projections,
  the SwiGLU MLP and the token embedding), trained by Distributed Lion.

``--adapter_path`` starts the policy from a PEFT adapter (r, alpha and the
targets from its ``adapter_config.json``) and ``--adapter_output`` writes
the trained one as a PEFT directory. ``--merged_output <path>.npz`` saves
the LoRA-merged, dequantized policy in the JAX package's flat format, any
other path as an HF ``save_pretrained`` directory with the tokenizer's
files (``models/hf_export.py``). It runs on the GPU unless
``DLION_PLATFORM=cpu``; without torchrun it trains a world of one. The
trainer's ``tokens_per_sec`` counts pairs x T, as the JAX trainer does.
``--vocab_chunks N`` scores all four passes from final hidden states and
the ``lm_head`` through the chunked-vocabulary cross entropy
(``train.dpo.sequence_logprob_chunked``).

``--tensor_parallel tp`` (JAX run_dpo.py:78-83, 155-205) splits the policy's
base and the reference over tensor groups of tp consecutive ranks
(``cli.run_sft.TPLora``): the reference is quantized whole, then each rank
keeps its slices (``ops.quant.validate_quant_tp`` first), and the adapters
split with their targets. ``--vocab_chunks`` with it is refused, in the JAX
package's words. ``--seq_parallel sp`` (JAX run_dpo.py:77-104, 207-228)
splits every ``[B, T]`` leaf's tokens over seq groups of sp ranks: policy and
reference run ring or Ulysses attention (``--seq_impl``), and each chunk's
partial logprobs are summed over the group before the pairwise loss
(``train.dpo.sequence_logprob_seq_parallel``, or its chunked form under
``--vocab_chunks``). ``--max_length`` (after the ``n_ctx`` clamp) must divide
over sp, and tp × sp is refused, both in the JAX package's words.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from distributed_lion_tpu_torch.cli.run_sft import TPLora, refuse_tp_vocab, write_outputs
from distributed_lion_tpu_torch.data.dpo import dpo_batch_iterator, prepare_dpo_batch
from distributed_lion_tpu_torch.data.sft import load_pairs_jsonl, synthetic_qa_pairs
from distributed_lion_tpu_torch.data.tokenizer import load_tokenizer
from distributed_lion_tpu_torch.models import hf_import
from distributed_lion_tpu_torch.models.llama import Llama, LlamaConfig, llama_init, tree_nbytes
from distributed_lion_tpu_torch.models.lora import (
    DPO_TARGET_PATTERNS,
    LoraConfig,
    adapter_named_parameters,
    lora_apply_fn,
    lora_init,
)
from distributed_lion_tpu_torch.ops.quant import map_tree, maybe_dequant, quantize_tree
from distributed_lion_tpu_torch.parallel.mesh import (
    SeqAxis,
    TensorAxis,
    init_distributed,
    make_grid,
    platform_device,
)
from distributed_lion_tpu_torch.train.dpo import make_dpo_loss_fn
from distributed_lion_tpu_torch.train.loop import (
    TrainConfig,
    Trainer,
    announce_guards,
    report_preempted,
)
from distributed_lion_tpu_torch.utils.argparsing import parse_dataclasses
from distributed_lion_tpu_torch.utils.serialization import load_pytree


@dataclasses.dataclass
class DPOArguments:
    """The JAX package's ``DPOArguments``: same names and defaults."""

    model_name: str = "llama2_7b"  # llama2_7b | llama3_8b | small | tiny
    model_path: Optional[str] = None  # a local HF Llama checkpoint: policy and reference
    dataset: str = "synthetic"     # synthetic | jsonl:<path>
    sft_checkpoint: Optional[str] = None  # merged .npz from run_sft
    beta: float = 0.1
    max_length: int = 1024
    max_prompt_length: int = 512
    num_train_samples: int = 512
    size_valid_set: int = 64
    sanity_check: bool = False
    attn_impl: str = "auto"        # ops.attention: auto | xla | flash | splash
    seq_impl: str = "ring"         # under --seq_parallel: ring | ulysses
    quant_ref: str = "none"        # none | int8 | nf4: the frozen reference
    quant_block: Optional[int] = None  # default: nf4 64, int8 256
    lora_r: int = 8
    lora_alpha: int = 16
    lora_dropout: float = 0.05     # adapter-branch dropout
    tokenizer_name: Optional[str] = None
    adapter_path: Optional[str] = None    # a PEFT adapter directory to start the policy from
    adapter_output: Optional[str] = None  # write the trained adapters as a PEFT directory
    merged_output: Optional[str] = None   # *.npz, or an HF save_pretrained directory


def dpo_records(args: DPOArguments) -> list:
    """The records of ``--dataset``, all of them (the eval split is cut
    after length filtering)."""
    if args.dataset == "synthetic":
        return synthetic_qa_pairs(args.num_train_samples + args.size_valid_set)
    if args.dataset.startswith("jsonl:"):
        return load_pairs_jsonl(args.dataset[len("jsonl:"):])[0]
    raise ValueError(f"unknown dataset spec {args.dataset!r}")


def load_sft_checkpoint(path: str, dtype: torch.dtype, device) -> Any:
    """A merged ``.npz`` weight tree on ``device``, float leaves cast to
    ``dtype`` (the JAX package's ``param_dtype`` normalization)."""
    def leaf(x):
        t = torch.from_numpy(np.asarray(x)).to(device)
        return t.to(dtype) if t.is_floating_point() else t
    return map_tree(leaf, load_pytree(path))


def dpo_loss_fn(model: Llama, base: Any, ref: Any, adapters: dict, lora_cfg: LoraConfig,
                beta: float, vocab_chunks: int = 0, tp: Optional[TensorAxis] = None,
                base_rule=None, seq: Optional[SeqAxis] = None):
    """The trainer's loss: the policy is ``model`` over ``base`` with
    ``adapters`` swapped in, the reference ``model`` over ``ref``; with
    ``vocab_chunks`` each pass gives ``(hidden, lm_head)`` (JAX
    run_dpo._hidden_and_head) and the logprobs stream through
    ``ops/xent.py``. Under ``tp`` the trees hold this rank's slices
    (``base_rule``) and the model reduces over the tensor group; under
    ``seq`` the tokens are the rank's chunk (the model's seq axis too)."""
    if vocab_chunks > 0:
        def forward(params, tokens):
            return (model.hidden(tokens, params),
                    maybe_dequant(params["lm_head"], model.cfg.compute_dtype))
    else:
        def forward(params, tokens):
            return model(tokens, params)
    policy = lora_apply_fn(forward, base, lora_cfg, tp=tp, base_rule=base_rule)
    return make_dpo_loss_fn(lambda tokens, seed: policy(adapters, tokens, dropout_seed=seed),
                            lambda tokens: forward(ref, tokens), beta=beta,
                            vocab_chunks=vocab_chunks, seq_axis=seq)


def main(argv=None) -> tuple[Trainer, Llama, dict, Any]:
    """Train, evaluate, and write ``--merged_output``; returns the (closed)
    trainer, the :class:`Llama` over the policy's dense base, the trained
    adapters (``{path: {"A", "B"}}``) and the frozen reference's tree."""
    args, train_cfg = parse_dataclasses((DPOArguments, TrainConfig), argv)
    refuse_tp_vocab(train_cfg, "run_dpo")
    if train_cfg.vocab_chunks > 0 and train_cfg.tensor_parallel > 1:
        raise NotImplementedError(
            "--vocab_chunks x --tensor_parallel on the DPO path is not wired (the TP head is "
            "already vocab-sharded; chunking it again buys nothing) — drop one")
    sp = train_cfg.seq_parallel
    if sp > 1 and train_cfg.tensor_parallel > 1:
        raise NotImplementedError(
            "--tensor_parallel x --seq_parallel on the DPO path is not wired; pick one")
    device = platform_device()
    group = init_distributed(device)
    grid = make_grid(train_cfg.tensor_parallel, group, sp=sp)
    rank0 = grid.rank == 0
    tok = load_tokenizer(args.tokenizer_name)
    pretrained = None
    if args.model_path:
        pretrained, model_cfg = hf_import.llama_from_hf(args.model_path, device=device)
        if rank0:
            print(f"[run_dpo] loaded pretrained Llama from {args.model_path}: "
                  f"{model_cfg.n_layer}L d={model_cfg.d_model} vocab={model_cfg.vocab_size}")
        model_cfg = dataclasses.replace(model_cfg, attn_impl=args.attn_impl,
                                        seq_impl=args.seq_impl)
    else:
        model_cfg = LlamaConfig.named(args.model_name, vocab_size=max(tok.vocab_size, 259),
                                      attn_impl=args.attn_impl, seq_impl=args.seq_impl)
    args.max_length = min(args.max_length, model_cfg.n_ctx)
    if sp > 1 and args.max_length % sp:
        # checked after the n_ctx clamp: the padded rows use this value
        raise ValueError(f"--max_length {args.max_length} (after the n_ctx clamp) must divide "
                         f"evenly over the {sp}-way seq axis")
    train_cfg.block_size = args.max_length

    # policy and reference both start from the SFT model (dpo_llama2.py:133-152)
    if args.sft_checkpoint:
        base = load_sft_checkpoint(args.sft_checkpoint, model_cfg.param_dtype, device)
        if rank0:
            print(f"[run_dpo] loaded SFT model from {args.sft_checkpoint}")
    elif pretrained is not None:
        base = pretrained
    else:
        if rank0:
            print("[run_dpo] no --sft_checkpoint/--model_path given; starting from fresh init")
        base = llama_init(model_cfg, seed=train_cfg.seed, device=device)
    del pretrained
    split = TPLora(grid, model_cfg)
    ref = base
    if args.quant_ref != "none":
        ref = split.shard_base(quantize_tree(base, args.quant_ref, block=args.quant_block))
    if args.adapter_path:
        # r, alpha and the targets are the checkpoint's, not --lora_r/--lora_alpha
        adapters, lora_cfg = hf_import.peft_to_lora(args.adapter_path, model_cfg, device=device)
        if rank0:
            print(f"[run_dpo] resumed PEFT adapter from {args.adapter_path} "
                  f"(r={lora_cfg.r} alpha={lora_cfg.alpha})")
    else:
        lora_cfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout,
                              target_patterns=DPO_TARGET_PATTERNS)
        adapters = lora_init(base, lora_cfg, seed=train_cfg.seed + 1)
    # the adapters are drawn over the whole base, then cut with it
    adapters = split.adapters(adapters, whole=True)
    base = split.shard_base(base)
    if args.quant_ref == "none":
        ref = base
    model = Llama(model_cfg, base, tp=grid.tensor, seq=grid.seq)
    named = adapter_named_parameters(adapters)
    if rank0:
        print(f"[run_dpo] LoRA adapters: {len(adapters)} sites, "
              f"{split.whole_count(named) / 1e3:.1f}k trainable params; policy base "
              f"{tree_nbytes(base) / 2**30:.2f} GiB, reference "
              f"{'the same tensors' if ref is base else f'{args.quant_ref}, {tree_nbytes(ref) / 2**30:.2f} GiB'}"
              f" on {device}")

    data = prepare_dpo_batch(dpo_records(args), tok, max_length=args.max_length,
                             max_prompt_length=args.max_prompt_length,
                             sanity_check=args.sanity_check)
    n = len(data["chosen"])
    n_valid = min(args.size_valid_set, n // 4)
    eval_data = {k: v[:n_valid] for k, v in data.items()} if n_valid else None
    train_data = {k: v[n_valid:] for k, v in data.items()}
    if rank0:
        print(f"[run_dpo] {n - n_valid} train / {n_valid} eval pairs (after length filtering)")

    trainer = Trainer(train_cfg, named,
                      dpo_loss_fn(model, base, ref, adapters, lora_cfg, args.beta,
                                  train_cfg.vocab_chunks, tp=grid.tensor,
                                  base_rule=split.base_rule, seq=grid.seq),
                      grid=grid, shard_rule=split.shard_rule(), model=model)
    announce_guards(trainer, "run_dpo")
    try:
        trainer.train(dpo_batch_iterator(train_data, trainer.global_train_batch(),
                                         seed=train_cfg.seed), eval_blocks=eval_data)
        if report_preempted(trainer, "run_dpo"):
            return trainer, model, adapters, ref
        if eval_data is not None:
            trainer.evaluate(eval_data)
        if trainer.checkpointer:
            trainer.save()
        if trainer.rank == 0 and (args.adapter_output or args.merged_output):
            whole_base, whole = split.gather(base, adapters, bool(args.merged_output))
            if rank0:
                write_outputs(args, whole_base, whole, lora_cfg, model_cfg, "run_dpo",
                              "merged policy")
    finally:
        trainer.close()
    return trainer, model, adapters, ref


if __name__ == "__main__":
    main()
