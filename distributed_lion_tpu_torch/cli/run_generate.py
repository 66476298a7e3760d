"""Text generation entry point: port of ``distributed_lion_tpu/cli/run_generate.py``.

Loads a model and decodes with a dense KV cache (``models/generate.py``):

    python -m distributed_lion_tpu_torch.cli.run_generate \\
        --model_path ./out/model.npz --model_family gpt2 --model_name tiny \\
        --prompt "Question: " --max_new_tokens 64 --temperature 0.8 --top_k 40

``--model_path`` takes a ``model.npz`` in the JAX package's format
(``utils/serialization.py``; ``run_clm`` and ``run_sft --merged_output``
write one), a training ``--output_dir`` holding one, or a Hugging Face
``save_pretrained`` directory (``models/hf_import.py``, the family detected
from it); without it the weights are a random init from ``--seed``.
Several ``--prompt`` values and the lines of ``--prompt_file`` decode as
one left-padded batch, each row as its solo run would (greedy rows are
identical to solo runs; sampled rows share one stream over the batch). It
runs on the GPU; ``DLION_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import List, Optional

import numpy as np
import torch

from distributed_lion_tpu_torch.data.tokenizer import load_tokenizer
from distributed_lion_tpu_torch.models import hf_import
from distributed_lion_tpu_torch.models.generate import generate
from distributed_lion_tpu_torch.models.gpt2 import (
    GPT2,
    GPT2Config,
    gpt2_decode,
    gpt2_init_cache,
)
from distributed_lion_tpu_torch.models.llama import (
    LlamaConfig,
    llama_decode,
    llama_init,
    llama_init_cache,
)
from distributed_lion_tpu_torch.parallel.mesh import platform_device
from distributed_lion_tpu_torch.utils.argparsing import parse_dataclasses
from distributed_lion_tpu_torch.utils.serialization import (
    llama_params_from_jax,
    load_pytree,
    tree_from_state_dict,
)


@dataclasses.dataclass
class GenerateArguments:
    model_path: Optional[str] = None  # model.npz, a training --output_dir, or an HF
    # save_pretrained directory (family detected); unset: a random init
    model_family: str = "gpt2"  # gpt2 | llama
    model_name: str = "tiny"    # gpt2: gpt2_124m | tiny; llama: llama2_7b | llama3_8b | tiny
    tokenizer_name: Optional[str] = None  # data.tokenizer.load_tokenizer; bytes when unset
    prompt: List[str] = dataclasses.field(default_factory=list)
    # one or more prompts, decoded as one left-padded batch; with neither
    # --prompt nor --prompt_file, "Hello"
    prompt_file: Optional[str] = None  # one prompt a line, after --prompt (blank lines skipped)
    max_new_tokens: int = 64
    temperature: float = 0.8
    top_k: Optional[int] = 40
    top_p: Optional[float] = None  # nucleus sampling mass (e.g. 0.95)
    seed: int = 0
    vocab_size: Optional[int] = None
    moe_experts: int = 0  # > 0: the checkpoint is GPT-2-MoE, as trained (--moe_experts,
    # --moe_every: model.npz holds no config); an HF directory ignores it
    moe_every: int = 2


def _is_hf_dir(path: Optional[str]) -> bool:
    """A ``save_pretrained`` directory has a config.json; a training
    ``--output_dir`` has none."""
    return bool(path) and os.path.isdir(path) and os.path.isfile(
        os.path.join(path, "config.json"))


def build(args: GenerateArguments, device=None) -> tuple:
    """``(tokenizer, config, weight tree on device, decode_fn,
    init_cache_fn)`` of ``args`` (JAX ``build``)."""
    device = platform_device() if device is None else device
    tok = load_tokenizer(args.tokenizer_name)
    vocab = args.vocab_size or tok.vocab_size
    if args.model_path and os.path.isdir(args.model_path) and not _is_hf_dir(args.model_path):
        npz = os.path.join(args.model_path, "model.npz")
        if not os.path.isfile(npz):
            raise FileNotFoundError(f"{args.model_path!r} is a directory with neither "
                                    "config.json (HF checkpoint) nor model.npz (training output)")
        args.model_path = npz

    params = cfg = None
    if _is_hf_dir(args.model_path):
        family = hf_import.detect_family(args.model_path)
        if family != args.model_family:
            print(f"[run_generate] --model_family {args.model_family} -> {family} "
                  "(detected from checkpoint)")
            args.model_family = family
        loader = hf_import.gpt2_from_hf if family == "gpt2" else hf_import.llama_from_hf
        params, cfg = loader(args.model_path, device=device)
    elif args.model_path:
        params = llama_params_from_jax(load_pytree(args.model_path), device)

    if args.model_family == "gpt2":
        moe = ({"moe_experts": args.moe_experts, "moe_every": args.moe_every}
               if args.moe_experts > 0 else {})
        cfg = cfg or (GPT2Config.tiny if args.model_name == "tiny"
                      else GPT2Config.gpt2_124m)(vocab_size=vocab, **moe)
        if params is None:
            params = tree_from_state_dict(GPT2(cfg, device=device, seed=args.seed))
        decode = partial(lambda c, p, t, k, pos, off=None: gpt2_decode(p, t, c, k, pos, off),
                         cfg)
        init_cache = partial(gpt2_init_cache, cfg, device=device)
    elif args.model_family == "llama":
        cfg = cfg or LlamaConfig.named(args.model_name, vocab_size=vocab)
        if params is None:
            params = llama_init(cfg, seed=args.seed, device=device)
        decode = partial(lambda c, p, t, k, pos, off=None: llama_decode(p, t, c, k, pos, off),
                         cfg)
        init_cache = partial(llama_init_cache, cfg, device=device)
    else:
        raise ValueError(f"unknown model family {args.model_family!r}")
    return tok, cfg, params, decode, init_cache


def main(argv=None):
    (args,) = parse_dataclasses((GenerateArguments,), argv)
    device = platform_device()
    tok, cfg, params, decode, init_cache = build(args, device)
    prompts = list(args.prompt)
    if args.prompt_file:
        with open(args.prompt_file) as f:
            prompts += [ln.rstrip("\n") for ln in f if ln.strip()]
        if not prompts:
            raise ValueError(f"no prompts: --prompt_file {args.prompt_file!r} holds no "
                             "non-blank lines and no --prompt was given")
    elif not prompts:
        prompts = ["Hello"]
    ids = [tok.encode(p, add_bos=False) or [0] for p in prompts]
    T = max(len(i) for i in ids)
    # left-padded to the longest prompt: every row's last prompt token at
    # slot T-1, its pad width the model's per-row offset
    batch = np.zeros((len(ids), T), np.int64)
    for r, seq in enumerate(ids):
        batch[r, T - len(seq):] = seq
    lens = torch.tensor([len(seq) for seq in ids], device=device)
    out = generate(decode, init_cache, params, torch.from_numpy(batch).to(device),
                   args.max_new_tokens,
                   generator=torch.Generator(device=device).manual_seed(args.seed),
                   temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                   eos_id=getattr(tok, "eos_id", None),
                   prompt_lens=None if len(ids) == 1 else lens)
    texts = [tok.decode([int(t) for t in row]) for row in out.tolist()]
    for p, t in zip(prompts, texts):
        print(p + t)
    return texts[0] if len(texts) == 1 else texts


if __name__ == "__main__":
    main()
