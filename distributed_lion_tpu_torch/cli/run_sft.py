"""SFT entry point: port of ``distributed_lion_tpu/cli/run_sft.py``, the reference's ``sft_llama2.py``.

    python -m distributed_lion_tpu_torch.cli.run_sft --lion --async_grad \\
        --model_name llama2_7b --quant nf4 --per_device_train_batch_size 4 \\
        --gradient_accumulation_steps 2 --max_steps 100 --output_dir ./sft

A Llama base, frozen and optionally quantized (``--quant nf4``, the
reference's 4-bit QLoRA base), LoRA adapters r 8, α 16 on ``wq``/``wv``,
packed synthetic or JSONL Q/A rows, and Distributed Lion over the adapters
only. Without torchrun it trains a world of one; it runs on the GPU unless
``DLION_PLATFORM=cpu``. The reference's two guards hold (packing excludes
``group_by_length``; ``gradient_checkpointing`` is refused, every block is
rematerialized anyway). The chars/token ratio is logged before training.
``--model_path`` finetunes a local Hugging Face Llama checkpoint instead
(``models/hf_import.py``: read tensor by tensor onto the device, and with
``--quant`` quantized leaf by leaf); ``--adapter_path`` starts from a PEFT
adapter (r, alpha and the targets from its ``adapter_config.json``);
``--adapter_output`` writes the trained adapters as a PEFT directory.
``--merged_output <path>.npz`` saves the LoRA-merged, dequantized model in
the JAX package's flat format, and any other path as an HF
``save_pretrained`` directory with the tokenizer's files
(``models/hf_export.py``). With ``--output_dir`` the trainer
checkpoints the adapters and their momenta every ``--save_steps``, resumes
from them (``train/loop.py``) and saves the last step; the frozen base is
not saved: a resume rebuilds it from the seed, as the JAX package does.

The synthetic path takes its vocabulary from the byte tokenizer,
``max(tokenizer vocab, 259)``, as the JAX package does without a Llama
tokenizer. ``--vocab_chunks N`` streams the (dequantized) ``lm_head``, in
its ``[d, V]`` layout, through the chunked-vocabulary cross entropy
(``ops/xent.py``), as the JAX package's ``_head_loss`` does.

``--tensor_parallel tp`` (JAX run_sft.py:235-294) splits the frozen base over
tensor groups of tp consecutive ranks (``parallel/tensor_parallel.py``): each
rank holds and dequantizes its slices of the (NF4) base, cut from the same
seeded init (``ops.quant.validate_quant_tp`` refuses a quantized leaf whose
blocks do not line up with the split), the adapters split with their targets
(``models.lora.lora_adapter_specs``) and the vote runs over each data group.
The outputs hold the whole adapters and base, gathered over the tensor
group. ``--seq_parallel sp`` (JAX run_sft.py:67-90, 130-182) splits every
packed row's tokens over seq groups of sp ranks (ring or Ulysses attention,
``--seq_impl``): it needs ``--packing`` and a ``--seq_length`` (after the
``n_ctx`` clamp) that divides over sp, in the JAX package's words; the loss
is the chunk's, dense or ``--vocab_chunks``
(``models.loss.clm_loss_seq_parallel``,
``ops.xent.chunked_clm_loss_seq_parallel``), and composes with
``--tensor_parallel``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
from torch import nn

from distributed_lion_tpu_torch.data.sft import (
    chars_token_ratio,
    constant_length_batches,
    load_pairs_jsonl,
    padded_batch_iterator,
    padded_examples,
    synthetic_qa_pairs,
)
from distributed_lion_tpu_torch.data.tokenizer import load_tokenizer
from distributed_lion_tpu_torch.models import hf_export, hf_import
from distributed_lion_tpu_torch.models.llama import Llama, LlamaConfig, llama_init, tree_nbytes
from distributed_lion_tpu_torch.models.lora import (
    LoraConfig,
    adapter_named_parameters,
    adapter_shard_rule,
    apply_adapters,
    lora_adapter_specs,
    lora_init,
    merge_lora,
)
from distributed_lion_tpu_torch.ops.quant import dequantize_tree, maybe_dequant, validate_quant_tp
from distributed_lion_tpu_torch.parallel import tensor_parallel as tpar
from distributed_lion_tpu_torch.parallel.mesh import init_distributed, make_grid, platform_device
from distributed_lion_tpu_torch.train.loop import (
    TrainConfig,
    Trainer,
    announce_guards,
    chunked_clm_loss_fn,
    clm_loss_fn,
    report_preempted,
)
from distributed_lion_tpu_torch.utils.argparsing import parse_dataclasses
from distributed_lion_tpu_torch.utils.serialization import save_pytree


@dataclasses.dataclass
class SFTArguments:
    """The JAX package's ``SFTArguments``: same names and defaults."""

    model_name: str = "llama2_7b"  # llama2_7b | llama3_8b | small | tiny
    model_path: Optional[str] = None  # a local HF Llama checkpoint: the pretrained base
    dataset: str = "synthetic"     # synthetic | jsonl:<path>
    seq_length: int = 1024
    size_valid_set: int = 64
    num_train_samples: int = 512   # synthetic corpus size
    quant: str = "none"            # none | int8 | nf4 (reference: nf4)
    quant_block: Optional[int] = None  # default: nf4 64, int8 256
    lora_r: int = 8
    lora_alpha: int = 16
    lora_dropout: float = 0.05     # adapter-branch dropout
    packing: bool = True
    group_by_length: bool = False
    gradient_checkpointing: bool = False
    attn_impl: str = "auto"        # ops.attention: auto | xla | flash | splash
    seq_impl: str = "ring"         # under --seq_parallel: ring | ulysses
    tokenizer_name: Optional[str] = None
    adapter_path: Optional[str] = None    # a PEFT adapter directory to start from
    adapter_output: Optional[str] = None  # write the trained adapters as a PEFT directory
    merged_output: Optional[str] = None   # *.npz, or an HF save_pretrained directory


def refuse_tp_vocab(train_cfg: TrainConfig, prog: str) -> None:
    """``--tp_vocab`` splits run_clm's dense heads only (JAX loop.py:802-811):
    the LoRA CLIs' losses would ignore it."""
    if train_cfg.tp_vocab:
        raise NotImplementedError(
            "--tp_vocab is wired for run_clm's dense dp x tp paths (gpt2 and llama families) "
            f"only; {prog}'s loss would silently ignore it")


def sft_records(args: SFTArguments) -> tuple:
    """``(train, valid)`` records of ``--dataset``."""
    if args.dataset == "synthetic":
        records = synthetic_qa_pairs(args.num_train_samples + args.size_valid_set)
        return records[args.size_valid_set:], records[: args.size_valid_set]
    if args.dataset.startswith("jsonl:"):
        return load_pairs_jsonl(args.dataset[len("jsonl:"):], size_valid_set=args.size_valid_set)
    raise ValueError(f"unknown dataset spec {args.dataset!r}")


def sft_batches(args: SFTArguments, tok, train, valid, global_batch: int, seed: int,
                ratio: float) -> tuple:
    """``(train iterator, eval rows or None)``: packed constant-length rows,
    or with ``--packing false`` padded, loss-masked ``{"tokens", "mask"}``
    rows, optionally grouped by length."""
    if args.packing:
        def batches():
            gen = constant_length_batches(train, tok, args.seq_length, infinite=True,
                                          chars_per_token=ratio)
            while True:
                yield np.stack([next(gen) for _ in range(global_batch)])

        rows = list(constant_length_batches(valid, tok, args.seq_length, infinite=False,
                                            chars_per_token=ratio)) if valid else []
        return batches(), (np.stack(rows) if rows else None)
    tokens, mask = padded_examples(train, tok, args.seq_length,
                                   group_by_length=args.group_by_length)
    it = padded_batch_iterator(tokens, mask, global_batch, seed=seed,
                               length_grouped=args.group_by_length)
    if not valid:
        return it, None
    ev_tokens, ev_mask = padded_examples(valid, tok, args.seq_length)
    return it, {"tokens": ev_tokens, "mask": ev_mask}


class TPLora:
    """The tensor split of a LoRA run over a Llama base: the grid's tensor
    axis, the base's shard rule and the adapters' (``lora_adapter_specs``);
    at tp 1 nothing is split."""

    def __init__(self, grid, model_cfg: LlamaConfig):
        self.grid, self.tensor = grid, grid.tensor
        self.base_rule = (tpar.llama_shard_dim if grid.tp > 1 else (lambda name: None))
        if grid.tp > 1:
            tpar.validate_tp(model_cfg, grid.tp, "llama")
        self.specs: dict = {}

    def shard_base(self, tree):
        """This rank's slices of a whole base (quantized leaves checked
        first)."""
        if self.grid.tp == 1:
            return tree
        validate_quant_tp(tree, self.base_rule, self.grid.tp)
        return tpar.shard_tree(tree, self.base_rule, self.grid.tp, self.tensor.rank)

    def adapters(self, adapters: dict, whole: bool) -> dict:
        """The adapters as parameters, cut to this rank's slices if
        ``whole``; records their specs."""
        self.specs = lora_adapter_specs(adapters, self.base_rule)
        return {path: {k: nn.Parameter(tpar.shard(t, self.specs[path][k], self.grid.tp,
                                                  self.tensor.rank) if whole else t)
                       for k, t in ab.items()} for path, ab in adapters.items()}

    def shard_rule(self):
        return adapter_shard_rule(self.specs) if self.grid.tp > 1 else None

    def whole_count(self, named) -> int:
        rule = adapter_shard_rule(self.specs)
        return sum(math.prod(tpar.full_shape(tuple(p.shape), rule(n) if self.grid.tp > 1
                                             else None, self.grid.tp)) for n, p in named)

    def gather(self, base, adapters: dict, with_base: bool) -> tuple:
        """The whole base (if ``with_base``) and adapters (a collective over
        the tensor group)."""
        if self.grid.tp == 1:
            return base, adapters
        whole = {path: {k: tpar.gather(t.detach(), self.specs[path][k], self.tensor)
                        for k, t in ab.items()} for path, ab in adapters.items()}
        return (tpar.gather_tree(base, self.base_rule, self.tensor) if with_base else None,
                whole)


def write_outputs(args, base, adapters: dict, lora_cfg: LoraConfig, model_cfg: LlamaConfig,
                  cli: str, what: str) -> None:
    """``--adapter_output`` (a PEFT directory) and ``--merged_output`` (the
    LoRA-merged, dequantized model: ``*.npz``, else an HF directory with the
    tokenizer's files), as the JAX ``run_sft`` and ``run_dpo`` write them."""
    if args.adapter_output:
        hf_export.lora_to_peft(adapters, model_cfg, lora_cfg, args.adapter_output,
                               base_model_name=args.model_path or "")
        print(f"[{cli}] PEFT adapter saved to {args.adapter_output}")
    if args.merged_output:
        merged = dequantize_tree(merge_lora(base, adapters, lora_cfg))
        if args.merged_output.endswith(".npz"):
            save_pytree(args.merged_output, merged)
        else:
            hf_export.llama_to_hf(merged, model_cfg, args.merged_output)
            hf_export.copy_tokenizer_files(args.tokenizer_name or args.model_path,
                                           args.merged_output)
        print(f"[{cli}] {what} saved to {args.merged_output}")


def main(argv=None) -> tuple[Trainer, Llama, dict]:
    """Train, evaluate, and write ``--merged_output``; returns the (closed)
    trainer, the :class:`Llama` over the frozen base and the trained
    adapters (``{path: {"A", "B"}}``)."""
    args, train_cfg = parse_dataclasses((SFTArguments, TrainConfig), argv)
    # the reference's guards (sft_llama2.py:53-59)
    if args.packing and args.group_by_length:
        raise ValueError("Cannot use both packing and group by length")
    if args.gradient_checkpointing:
        raise ValueError(
            "gradient_checkpointing with LoRA is rejected for parity with the reference "
            "(sft_llama2.py:56-59); every block is rematerialized regardless")
    sp = train_cfg.seq_parallel
    if sp > 1 and not args.packing:
        raise NotImplementedError(
            "--seq_parallel needs --packing: padded/masked per-example rows are not wired "
            "across sequence shards")
    refuse_tp_vocab(train_cfg, "run_sft")
    device = platform_device()
    group = init_distributed(device)
    grid = make_grid(train_cfg.tensor_parallel, group, sp=sp)
    rank0 = grid.rank == 0
    tok = load_tokenizer(args.tokenizer_name)
    train, valid = sft_records(args)
    ratio = chars_token_ratio(train, tok)
    if rank0:
        print(f"[run_sft] chars/token ratio: {ratio:.2f} over {min(len(train), 400)} samples")

    quant = None if args.quant == "none" else args.quant
    if args.model_path:
        base, model_cfg = hf_import.llama_from_hf(args.model_path, device=device, quant=quant,
                                                  quant_block=args.quant_block)
        if rank0:
            print(f"[run_sft] loaded pretrained Llama from {args.model_path}: "
                  f"{model_cfg.n_layer}L d={model_cfg.d_model} vocab={model_cfg.vocab_size}")
        if tok.vocab_size > model_cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab {tok.vocab_size} exceeds the checkpoint's "
                f"{model_cfg.vocab_size}; pass the checkpoint's own tokenizer")
        model_cfg = dataclasses.replace(model_cfg, attn_impl=args.attn_impl,
                                        seq_impl=args.seq_impl)
    else:
        model_cfg = LlamaConfig.named(args.model_name, vocab_size=max(tok.vocab_size, 259),
                                      attn_impl=args.attn_impl, seq_impl=args.seq_impl)
    args.seq_length = min(args.seq_length, model_cfg.n_ctx)
    if sp > 1 and args.seq_length % sp:
        # checked after the n_ctx clamp: the packed rows use this value
        raise ValueError(f"--seq_length {args.seq_length} (after the n_ctx clamp) must divide "
                         f"evenly over the {sp}-way seq axis")
    train_cfg.block_size = args.seq_length
    split = TPLora(grid, model_cfg)
    if quant and rank0:
        print(f"[run_sft] quantizing frozen base to {quant}")
    if args.model_path:
        base = split.shard_base(base)
    else:
        base = llama_init(model_cfg, seed=train_cfg.seed, device=device, quant=quant,
                          quant_block=args.quant_block, tp=grid.tensor)
    if args.adapter_path:
        # r, alpha and the targets are the checkpoint's, not --lora_r/--lora_alpha
        adapters, lora_cfg = hf_import.peft_to_lora(args.adapter_path, model_cfg, device=device)
        adapters = split.adapters(adapters, whole=True)
        if rank0:
            print(f"[run_sft] resumed PEFT adapter from {args.adapter_path} "
                  f"(r={lora_cfg.r} alpha={lora_cfg.alpha})")
    else:
        lora_cfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout)
        adapters = split.adapters(lora_init(base, lora_cfg, seed=train_cfg.seed + 1,
                                            tp=grid.tensor, base_rule=split.base_rule),
                                  whole=False)
    model = Llama(model_cfg, base, tp=grid.tensor, seq=grid.seq)
    named = adapter_named_parameters(adapters)
    if rank0:
        print(f"[run_sft] LoRA adapters: {len(adapters)} sites, "
              f"{split.whole_count(named) / 1e3:.1f}k trainable params; frozen base "
              f"{tree_nbytes(base) / 2**30:.2f} GiB on {device}"
              + (f" (this rank's slices of {grid.tp})" if grid.tp > 1 else ""))

    def effective(seed):
        return apply_adapters(base, adapters, lora_cfg, dropout_seed=seed, tp=grid.tensor,
                              base_rule=split.base_rule)

    if train_cfg.vocab_chunks > 0:  # JAX run_sft._head_loss's chunked branch
        def hidden_and_head(tokens, seed):
            eff = effective(seed)
            return (model.hidden(tokens, eff),
                    maybe_dequant(eff["lm_head"], model_cfg.compute_dtype))

        loss_fn = chunked_clm_loss_fn(hidden_and_head, train_cfg.vocab_chunks, emb_layout="dv",
                                      seq=grid.seq)
    else:
        loss_fn = clm_loss_fn(lambda tokens, seed: model(tokens, effective(seed)), grid.seq)
    trainer = Trainer(train_cfg, named, loss_fn, grid=grid, shard_rule=split.shard_rule())
    train_iter, eval_blocks = sft_batches(args, tok, train, valid, trainer.global_train_batch(),
                                          train_cfg.seed, ratio)
    announce_guards(trainer, "run_sft")
    try:
        trainer.train(train_iter, eval_blocks=eval_blocks)
        if report_preempted(trainer, "run_sft"):
            return trainer, model, adapters
        if eval_blocks is not None:
            trainer.evaluate(eval_blocks)
        if trainer.checkpointer:
            trainer.save()
        if trainer.rank == 0 and (args.adapter_output or args.merged_output):
            whole_base, whole = split.gather(base, adapters, bool(args.merged_output))
            if rank0:
                write_outputs(args, whole_base, whole, lora_cfg, model_cfg, "run_sft",
                              "merged model")
    finally:
        trainer.close()
    return trainer, model, adapters


if __name__ == "__main__":
    main()
