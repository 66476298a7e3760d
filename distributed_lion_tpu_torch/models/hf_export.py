"""Hugging Face checkpoints out: port of ``distributed_lion_tpu/models/hf_export.py``.

The reference ends every workload by writing an HF checkpoint: the
Trainer's ``save_model`` (``run_clm.py:611-622``) and the SFT merge flow
(``sft_llama2.py:183-199``: save, reload, ``merge_and_unload``, save the
merged model). This module is the exact inverse of ``models/hf_import.py``
(the Conv1D orientation, the q|k|v packing, the interleaved → half-rotation
RoPE permutation, the tied head), so a model trained by the port loads in
``GPT2LMHeadModel.from_pretrained``, ``LlamaForCausalLM.from_pretrained``
and ``peft.PeftModel.from_pretrained`` (tests/test_torch_hf.py).

Weights are written by the port's own safetensors writer
(:func:`_write_tensors`: the header padded with spaces to a multiple of 8,
``__metadata__ = {"format": "pt"}``, which ``from_pretrained`` demands,
and each tensor's raw little-endian bytes in its own dtype, so bfloat16
survives), one tensor at a time from wherever it lies (a device tensor is
copied to the host alone), beside a ``config.json``. A model past
:data:`MAX_SHARD_BYTES` is split into ``model-0000i-of-0000n.safetensors``
files under a ``model.safetensors.index.json``, as ``save_pretrained`` does. Quantized
(NF4/int8) frozen bases must be dequantized first
(``ops.quant.dequantize_tree``).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Any, Optional

import torch

from distributed_lion_tpu_torch.models.hf_import import SAFETENSORS_DTYPES, _PEFT_MODULES

_DTYPE_NAMES = {dt: name for name, dt in SAFETENSORS_DTYPES.items()}
# a checkpoint past this many bytes is written as shards of at most this
# many, as Llama-2-7b-hf is published (two files of 10 GB and 3.5 GB)
MAX_SHARD_BYTES = 10 * 10**9


def _write_tensors(tensors: dict, path: str, stem: str) -> None:
    """``{name: torch.Tensor}`` → ``<path>/<stem>.safetensors``. Tensors go
    widest dtype first, then by name, so every tensor's offset is a multiple
    of its element size."""
    os.makedirs(path, exist_ok=True)
    order = sorted(tensors, key=lambda k: (-tensors[k].dtype.itemsize, k))
    header: dict = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name in order:
        t = tensors[name]
        nbytes = t.numel() * t.dtype.itemsize
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(os.path.join(path, f"{stem}.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().contiguous().cpu().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy().data)


def _save_state_dict(sd: dict, path: str, config: dict) -> None:
    """``{name: torch.Tensor}`` → ``model.safetensors`` (or, past
    :data:`MAX_SHARD_BYTES`, index-sharded files) + ``config.json`` under
    ``path``."""
    total = sum(t.numel() * t.dtype.itemsize for t in sd.values())
    if total <= MAX_SHARD_BYTES:
        _write_tensors(sd, path, "model")
    else:
        shards: list = [[]]
        size = 0
        for name, t in sd.items():  # greedy, in the state dict's order
            nbytes = t.numel() * t.dtype.itemsize
            if shards[-1] and size + nbytes > MAX_SHARD_BYTES:
                shards.append([])
                size = 0
            shards[-1].append(name)
            size += nbytes
        weight_map = {}
        for i, names in enumerate(shards):
            stem = f"model-{i + 1:05d}-of-{len(shards):05d}"
            _write_tensors({n: sd[n] for n in names}, path, stem)
            weight_map.update(dict.fromkeys(names, f"{stem}.safetensors"))
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f,
                      indent=1)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1, allow_nan=False)


# ----------------------------------------------------------------------- GPT-2

def gpt2_to_hf(params: dict, cfg: Any, path: str) -> None:
    """A GPT-2 weight tree (the JAX package's layout, tensors) → an HF
    ``GPT2LMHeadModel`` checkpoint directory.

    Inverse of ``hf_import.gpt2_from_hf``: the stacked qkv [d, 3, d]
    flattens to Conv1D's c_attn [d, 3d]; the head is tied to wte (GPT-2's
    convention), so only ``transformer.*`` weights are written.
    """
    d = cfg.d_model
    sd = {
        # a vocab_pad_multiple layout carries alignment rows HF models don't
        # have; slice back to the true vocab (no-op when unpadded)
        "transformer.wte.weight": params["wte"][: cfg.vocab_size],
        "transformer.wpe.weight": params["wpe"],
        "transformer.ln_f.weight": params["ln_f"]["scale"],
        "transformer.ln_f.bias": params["ln_f"]["bias"],
    }
    for i, blk in enumerate(params["blocks"]):
        if "moe" in blk:
            raise ValueError(
                "MoE blocks have no HF GPT-2 equivalent; export is for the "
                "dense reference architecture"
            )
        h = f"transformer.h.{i}"
        sd[f"{h}.ln_1.weight"] = blk["ln_1"]["scale"]
        sd[f"{h}.ln_1.bias"] = blk["ln_1"]["bias"]
        sd[f"{h}.attn.c_attn.weight"] = blk["attn"]["qkv"].reshape(d, 3 * d)
        sd[f"{h}.attn.c_attn.bias"] = blk["attn"]["qkv_b"].reshape(3 * d)
        sd[f"{h}.attn.c_proj.weight"] = blk["attn"]["proj"]
        sd[f"{h}.attn.c_proj.bias"] = blk["attn"]["proj_b"]
        sd[f"{h}.ln_2.weight"] = blk["ln_2"]["scale"]
        sd[f"{h}.ln_2.bias"] = blk["ln_2"]["bias"]
        sd[f"{h}.mlp.c_fc.weight"] = blk["mlp"]["fc"]
        sd[f"{h}.mlp.c_fc.bias"] = blk["mlp"]["fc_b"]
        sd[f"{h}.mlp.c_proj.weight"] = blk["mlp"]["proj"]
        sd[f"{h}.mlp.c_proj.bias"] = blk["mlp"]["proj_b"]
    config = {
        "model_type": "gpt2",
        "architectures": ["GPT2LMHeadModel"],
        "vocab_size": int(cfg.vocab_size),
        "n_layer": int(cfg.n_layer),
        "n_head": int(cfg.n_head),
        "n_embd": int(cfg.d_model),
        "n_positions": int(cfg.n_ctx),
        "n_ctx": int(cfg.n_ctx),
        "tie_word_embeddings": True,
    }
    _save_state_dict(sd, path, config)


# ----------------------------------------------------------------------- Llama

def write_model_card(path: str, *, model_type: str, train_summary: dict) -> None:
    """A README.md model card beside the exported weights (the reference
    ends run_clm with ``trainer.create_model_card``, ``run_clm.py:650-653``):
    ``train_summary``'s key-values as a table."""
    os.makedirs(path, exist_ok=True)
    lines = [
        f"# {model_type} — trained with distributed_lion_tpu_torch",
        "",
        "Trained with majority-vote **Distributed Lion** "
        "(arXiv:2404.00438) with PyTorch.",
        "",
        "| key | value |",
        "|---|---|",
    ]
    lines += [f"| {k} | {v} |" for k, v in train_summary.items()]
    lines.append("")
    with open(os.path.join(path, "README.md"), "w") as f:
        f.write("\n".join(lines))


_TOKENIZER_FILES = (
    "vocab.json", "merges.txt", "tokenizer.json", "tokenizer.model",
    "tokenizer_config.json", "special_tokens_map.json",
)


def copy_tokenizer_files(tokenizer_name: Optional[str], path: str) -> list:
    """Copy tokenizer files next to the exported weights, if resolvable.

    HF's ``save_pretrained`` writes the tokenizer beside the model, so
    ``AutoTokenizer.from_pretrained`` works on the export directory.
    ``tokenizer_name`` is the spec ``data.tokenizer.load_tokenizer`` takes:
    ``bpe:<dir>``, ``sp:<file>``, a tokenizer file, or a directory holding
    tokenizer files. HF-cache names and the byte tokenizer have no local
    files to copy (the caller's model card records the spec). Returns the
    names of the files copied.
    """
    if not tokenizer_name:
        return []
    src = tokenizer_name
    for prefix in ("bpe:", "sp:"):
        if src.startswith(prefix):
            src = src[len(prefix):]
            break
    copied = []
    if os.path.isfile(src):
        # a bare tokenizer.model / tokenizer.json / vocab file path
        name = os.path.basename(src)
        if name in _TOKENIZER_FILES or src.endswith(".model"):
            os.makedirs(path, exist_ok=True)
            dst = "tokenizer.model" if src.endswith(".model") else name
            shutil.copy2(src, os.path.join(path, dst))
            copied.append(dst)
        return copied
    if not os.path.isdir(src):
        return []
    os.makedirs(path, exist_ok=True)
    for name in _TOKENIZER_FILES:
        fp = os.path.join(src, name)
        if os.path.isfile(fp):
            shutil.copy2(fp, os.path.join(path, name))
            copied.append(name)
    return copied


def _rope_from_interleaved(w_out_in: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Inverse of ``hf_import._rope_to_interleaved``: per head, channel 2i
    goes back to slot i and channel 2i+1 to slot i + hd/2 (HF's
    half-rotation layout)."""
    out, d_in = w_out_in.shape
    hd = out // n_heads
    w = w_out_in.reshape(n_heads, hd // 2, 2, d_in)
    return w.transpose(1, 2).reshape(out, d_in)


def lora_to_peft(adapters: dict, model_cfg: Any, lora_cfg: Any,
                 path: str, base_model_name: str = "") -> None:
    """Trained LoRA adapters → a HF PEFT checkpoint directory.

    The reference's SFT saves the PEFT adapter before merging
    (``sft_llama2.py:183-190``); this is that artifact for the port's
    adapters: ``adapter_model.safetensors`` + ``adapter_config.json``,
    loadable by ``peft.PeftModel.from_pretrained`` over an exported base
    (:func:`llama_to_hf`). Per adapted leaf (A [in, r], B [r, out] on an
    [in, out] weight): PEFT's ``lora_A.weight`` = A.T and ``lora_B.weight`` =
    B.T, with the q/k projections' B rows permuted back from the
    interleaved RoPE layout to HF's half-rotation one. ``scaling =
    alpha/r`` is PEFT's convention, so values export verbatim, as float32.
    """
    sd = {}
    modules = set()
    for apath, ab in adapters.items():
        A, B = ab["A"].detach().float(), ab["B"].detach().float()
        parts = apath.split("/")  # e.g. blocks/3/attn/wq
        if apath == "wte":
            # PEFT Embedding adapter layout: lora_embedding_A is
            # [r, num_embeddings], lora_embedding_B is [embedding_dim, r]
            # (transposed relative to the Linear lora_A/lora_B convention).
            prefix = "base_model.model.model.embed_tokens"
            sd[f"{prefix}.lora_embedding_A"] = A.t()  # [r, V]
            sd[f"{prefix}.lora_embedding_B"] = B.t()  # [d, r]
            modules.add("embed_tokens")
            continue
        if parts[0] != "blocks" or parts[-1] not in _PEFT_MODULES:
            raise ValueError(
                f"adapter on {apath!r} has no PEFT-Llama equivalent "
                f"(exportable targets: {sorted(_PEFT_MODULES)} + wte)"
            )
        layer = parts[1]
        module, heads_attr = _PEFT_MODULES[parts[-1]]
        B = B.t()  # [out, r]
        if heads_attr is not None:
            B = _rope_from_interleaved(B, int(getattr(model_cfg, heads_attr)))
        prefix = f"base_model.model.model.layers.{layer}.{module}"
        sd[f"{prefix}.lora_A.weight"] = A.t()  # [r, in]
        sd[f"{prefix}.lora_B.weight"] = B
        modules.add(module.split(".")[-1])

    _write_tensors(sd, path, "adapter_model")
    config = {
        "peft_type": "LORA",
        "task_type": "CAUSAL_LM",
        "r": int(lora_cfg.r),
        "lora_alpha": int(lora_cfg.alpha),
        "lora_dropout": 0.0,
        "bias": "none",
        "fan_in_fan_out": False,
        "inference_mode": True,
        "target_modules": sorted(modules),
        "base_model_name_or_path": base_model_name,
    }
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump(config, f, indent=1, allow_nan=False)


def llama_to_hf(params: dict, cfg: Any, path: str) -> None:
    """A dense Llama weight tree → an HF ``LlamaForCausalLM`` checkpoint
    directory (sharded past :data:`MAX_SHARD_BYTES`).

    Inverse of ``hf_import.llama_from_hf``: [in, out] matmul weights
    transpose back to Linear's [out, in]; q/k projections permute from
    interleaved to half-rotation RoPE; a tied head (``lm_head`` equal to
    ``wte.T``, compared where the tensors lie) is omitted with
    ``tie_word_embeddings``.
    """
    p = {k: v for k, v in params.items() if k != "blocks"}
    wte, lm_head = p["wte"].detach(), p["lm_head"].detach()
    tied = lm_head.shape == wte.t().shape and torch.equal(lm_head, wte.t())
    sd = {
        "model.embed_tokens.weight": wte,
        "model.norm.weight": p["ln_f"]["scale"],
    }
    if not tied:
        sd["lm_head.weight"] = lm_head.t()
    for i, blk in enumerate(params["blocks"]):
        L = f"model.layers.{i}"
        a, m = blk["attn"], blk["mlp"]
        sd[f"{L}.input_layernorm.weight"] = blk["ln_attn"]["scale"]
        sd[f"{L}.self_attn.q_proj.weight"] = _rope_from_interleaved(
            a["wq"].detach().t(), cfg.n_head)
        sd[f"{L}.self_attn.k_proj.weight"] = _rope_from_interleaved(
            a["wk"].detach().t(), cfg.n_kv_head)
        sd[f"{L}.self_attn.v_proj.weight"] = a["wv"].t()
        sd[f"{L}.self_attn.o_proj.weight"] = a["wo"].t()
        sd[f"{L}.post_attention_layernorm.weight"] = blk["ln_mlp"]["scale"]
        sd[f"{L}.mlp.gate_proj.weight"] = m["w_gate"].t()
        sd[f"{L}.mlp.up_proj.weight"] = m["w_up"].t()
        sd[f"{L}.mlp.down_proj.weight"] = m["w_down"].t()
    config = {
        "model_type": "llama",
        "architectures": ["LlamaForCausalLM"],
        "vocab_size": int(cfg.vocab_size),
        "num_hidden_layers": int(cfg.n_layer),
        "num_attention_heads": int(cfg.n_head),
        "num_key_value_heads": int(cfg.n_kv_head),
        "hidden_size": int(cfg.d_model),
        "intermediate_size": int(cfg.d_ff),
        "max_position_embeddings": int(cfg.n_ctx),
        "rope_theta": float(cfg.rope_theta),
        "rms_norm_eps": float(cfg.rms_eps),
        "tie_word_embeddings": bool(tied),
    }
    _save_state_dict(sd, path, config)
