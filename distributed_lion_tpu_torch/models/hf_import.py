"""Hugging Face checkpoints in: port of ``distributed_lion_tpu/models/hf_import.py``.

The reference finetunes *pretrained* models: GPT-2 through
``AutoModelForCausalLM.from_pretrained`` (``run_clm.py:425-444``) and
Llama-2-7B for SFT and DPO (``sft_llama2.py:141-154``,
``dpo_llama2.py:133-152``). Import is from local files only: a
``save_pretrained`` directory (``model.safetensors``, optionally sharded
under ``model.safetensors.index.json``, or ``pytorch_model.bin``, optionally
sharded, beside ``config.json``), a bare ``.safetensors``, ``.bin`` or
``.pt`` file, or an ``.npz``.

The port reads the safetensors format itself (:class:`SafetensorsFile`: an
8-byte little-endian header length, a JSON header, the raw little-endian
data), so it needs neither ``safetensors`` nor ``transformers``.
:func:`load_state_dict` is lazy: it reads the headers, and each lookup
reads one tensor from its shard into a host buffer of its own and moves it
to the caller's device in its stored dtype, so the host holds one tensor
at a time, never the checkpoint. (A memory-mapped reader that dropped each
tensor's pages after its copy held one tensor resident on a CPU host, but
9.3 GiB more on an H100 host while a 13.5 GB Llama-2-7B was read; PERF.md.) The importers convert each leaf on
the device as the JAX package converts it on the host: through float32
(``hf_import.py:47-48, 59-60`` upcasts every float) to the param dtype,
so the trees are bit for bit the JAX package's (exact for float16 and
bfloat16 sources; a double rounding for a float64 one, as there), and with
``quant`` each leaf is quantized as it is made (``ops.quant.quantize_leaf``,
what ``quantize_tree`` of the float32 tree gives).

Layouts (the conversion work):

- **GPT-2 stores Conv1D weights as [in, out]**, so ``c_attn``, ``c_proj`` and
  ``c_fc`` need no transpose; ``c_attn.weight [d, 3d]`` reshapes straight
  into the stacked ``qkv [d, 3, d]`` (q|k|v are contiguous on the output
  dim).
- **Llama stores Linear weights as [out, in]**: every projection is
  transposed into the [in, out] matmul layout.
- **RoPE**: HF Llama rotates halves (``rotate_half``); the port's
  ``apply_rope`` pairs even and odd columns (the JAX package's interleaved
  form). Per head, ``new[2i] = old[i]`` and ``new[2i+1] = old[i + hd/2]`` on
  the q and k output channels (``wq`` over ``n_head``, ``wk`` over
  ``n_kv_head``, and PEFT's q/k ``lora_B`` rows).

The importers return the JAX package's weight trees (nested dicts and
lists) as tensors on the caller's device: ``Trainer.for_gpt2`` takes a GPT-2
tree through ``utils.serialization.state_dict_from_tree``, and
``Trainer.for_llama`` and the LoRA entry points take a Llama tree as it is.
"""

from __future__ import annotations

import json
import math
import os
import struct
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.models.llama import LlamaConfig
from distributed_lion_tpu_torch.models.lora import LoraConfig
from distributed_lion_tpu_torch.ops.quant import quantize_leaf
from distributed_lion_tpu_torch.parallel.mesh import resolve_device

# safetensors dtype names (the format's spec) → torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


# --------------------------------------------------------------------- loading

class SafetensorsFile:
    """One ``.safetensors`` file: the header parsed and checked;
    :meth:`tensor` reads one tensor's bytes (``os.preadv``) into a host
    buffer of its own."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            size = os.fstat(self._fd).st_size
            head = os.pread(self._fd, 8, 0)
            if len(head) < 8:
                raise ValueError(f"{path!r} is not a safetensors file: {size} bytes")
            (n,) = struct.unpack("<Q", head)
            if n > size - 8:
                raise ValueError(f"{path!r}: header length {n} exceeds the file's {size} bytes")
            header = json.loads(os.pread(self._fd, n, 8))
            header.pop("__metadata__", None)
            self._start = 8 + n
            data_len = size - self._start
            self._entries: dict = {}
            for name, e in header.items():
                if e["dtype"] not in SAFETENSORS_DTYPES:
                    raise ValueError(f"{path!r}: tensor {name!r} has unknown dtype "
                                     f"{e['dtype']!r}")
                dtype = SAFETENSORS_DTYPES[e["dtype"]]
                shape = tuple(int(s) for s in e["shape"])
                lo, hi = (int(o) for o in e["data_offsets"])
                nbytes = math.prod(shape) * dtype.itemsize
                if not 0 <= lo <= hi <= data_len or hi - lo != nbytes:
                    raise ValueError(
                        f"{path!r}: tensor {name!r} ({e['dtype']} {list(shape)}, {nbytes} "
                        f"bytes) has data_offsets [{lo}, {hi}] outside the {data_len} data bytes")
                self._entries[name] = (dtype, shape, lo, hi)
        except BaseException:
            os.close(self._fd)
            raise

    def keys(self):
        return self._entries.keys()

    def shape(self, name: str) -> tuple:
        return self._entries[name][1]

    def tensor(self, name: str) -> torch.Tensor:
        dtype, shape, lo, hi = self._entries[name]
        buf = torch.empty(hi - lo, dtype=torch.uint8)
        view, done = memoryview(buf.numpy()), 0
        while done < hi - lo:  # one read may return less than asked
            got = os.preadv(self._fd, [view[done:]], self._start + lo + done)
            if got <= 0:
                raise ValueError(f"{self.path!r}: tensor {name!r} is cut short")
            done += got
        return buf.view(dtype).reshape(shape)

    def close(self) -> None:
        os.close(self._fd)


class _TorchBin:
    """A ``torch.save`` state dict (``pytorch_model.bin``), loaded whole on
    the host as the JAX package loads it."""

    def __init__(self, path: str):
        self._sd = torch.load(path, map_location="cpu", weights_only=True)

    def keys(self):
        return self._sd.keys()

    def shape(self, name: str) -> tuple:
        return tuple(self._sd[name].shape)

    def tensor(self, name: str) -> torch.Tensor:
        return self._sd[name]

    def close(self) -> None:
        self._sd = {}


class _Npz:
    def __init__(self, path: str):
        self._z = np.load(path)

    def keys(self):
        return self._z.files

    def shape(self, name: str) -> tuple:
        return self._z[name].shape

    def tensor(self, name: str) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(self._z[name]))

    def close(self) -> None:
        self._z.close()


class StateDict(Mapping):
    """``{HF name: tensor}`` over a checkpoint's files, read lazily: each
    lookup reads one tensor and moves it onto ``device`` in its stored
    dtype, so the host holds one tensor at a time. A context manager;
    ``close`` closes the files."""

    def __init__(self, sources: list, device):
        self.device = resolve_device(device)
        self._sources = sources
        # name → (source, the name in that source)
        self._where = {name: (src, name) for src in sources for name in src.keys()}

    def __getitem__(self, name: str) -> torch.Tensor:
        src, key = self._where[name]
        return src.tensor(key).to(self.device)

    def __contains__(self, name) -> bool:  # Mapping's would read the tensor
        return name in self._where

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def keys(self):
        return self._where.keys()

    def shape(self, name: str) -> tuple:
        src, key = self._where[name]
        return src.shape(key)

    def renamed(self, names: dict) -> "StateDict":
        """The same tensors with ``old`` read as ``names[old]``."""
        out = StateDict(self._sources, self.device)
        out._where = {names.get(k, k): v for k, v in self._where.items()}
        return out

    def close(self) -> None:
        for src in self._sources:
            src.close()

    def __enter__(self) -> "StateDict":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _shards(index: str) -> list:
    with open(index) as f:
        return sorted(set(json.load(f)["weight_map"].values()))


def _load_safetensors(path: str, device="cpu") -> StateDict:
    """One ``.safetensors`` file as a lazy :class:`StateDict`."""
    return StateDict([SafetensorsFile(path)], device)


def _load_torch_bin(path: str, device="cpu") -> StateDict:
    """One ``torch.save`` file (``torch.load(..., weights_only=True)``)."""
    return StateDict([_TorchBin(path)], device)


def load_state_dict(path: str, device="cpu") -> StateDict:
    """A local checkpoint as a lazy ``{hf_name: tensor}`` (stored dtypes;
    the importers apply the JAX package's float32 rule per leaf).

    ``path`` may be a ``save_pretrained`` directory, a single
    ``.safetensors`` / ``.bin`` / ``.pt`` file, or an ``.npz``; the JAX
    package's dispatch and errors."""
    if os.path.isdir(path):
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index):
            return StateDict([SafetensorsFile(os.path.join(path, s))
                              for s in _shards(index)], device)
        single = os.path.join(path, "model.safetensors")
        if os.path.exists(single):
            return _load_safetensors(single, device)
        bin_index = os.path.join(path, "pytorch_model.bin.index.json")
        if os.path.exists(bin_index):
            return StateDict([_TorchBin(os.path.join(path, s))
                              for s in _shards(bin_index)], device)
        bin_path = os.path.join(path, "pytorch_model.bin")
        if os.path.exists(bin_path):
            return _load_torch_bin(bin_path, device)
        raise FileNotFoundError(
            f"no model.safetensors(.index.json) or pytorch_model.bin under {path!r}"
        )
    if path.endswith(".safetensors"):
        return _load_safetensors(path, device)
    if path.endswith((".bin", ".pt")):
        return _load_torch_bin(path, device)
    if path.endswith(".npz"):
        return StateDict([_Npz(path)], device)
    raise ValueError(f"unrecognized checkpoint format: {path!r}")


def load_hf_config(path: str) -> Optional[dict]:
    cfg_path = os.path.join(path, "config.json") if os.path.isdir(path) else None
    if cfg_path and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            return json.load(f)
    return None


def _strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    """``sd`` with ``prefix`` cut off the names that carry it, when any does."""
    if any(k.startswith(prefix) for k in sd):
        return sd.renamed({k: k[len(prefix):] for k in sd if k.startswith(prefix)})
    return sd


def _as_param(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's dtype rule on the device: a float leaf through
    float32 (its host upcast) to ``dtype`` (``jnp.asarray(x, dt)``)."""
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(dtype)


# ----------------------------------------------------------------------- GPT-2

def gpt2_from_hf(path: str, param_dtype: Optional[torch.dtype] = None, device="cpu",
                 **config_overrides):
    """HF GPT-2 checkpoint → ``(params, GPT2Config)``, the tree on ``device``.

    Parity target: ``GPT2LMHeadModel.from_pretrained`` as used by the
    reference's run_clm (``run_clm.py:425-444``); the tree is the JAX
    package's ``gpt2_from_hf`` bit for bit (tests/test_torch_hf.py).
    """
    with load_state_dict(path, device) as raw:
        sd = _strip_prefix(raw, "transformer.")
        hf_cfg = load_hf_config(path) or {}
        vocab, d = sd.shape("wte.weight")
        n_layer = 1 + max(
            int(k.split(".")[1]) for k in sd if k.startswith("h.") and k.split(".")[1].isdigit()
        )
        n_head = int(hf_cfg.get("n_head", config_overrides.get("n_head", 12)))
        cfg_kw = dict(vocab_size=vocab, n_layer=n_layer, n_head=n_head, d_model=d,
                      n_ctx=sd.shape("wpe.weight")[0])
        cfg_kw.update(config_overrides)
        if param_dtype is not None:
            cfg_kw["param_dtype"] = param_dtype
        cfg = GPT2Config(**cfg_kw)
        dt = cfg.param_dtype

        def leaf(name):
            return _as_param(sd[name], dt)

        def ln(prefix):
            return {"scale": leaf(f"{prefix}.weight"), "bias": leaf(f"{prefix}.bias")}

        params = {"wte": leaf("wte.weight"), "wpe": leaf("wpe.weight"), "ln_f": ln("ln_f"),
                  "blocks": []}
        for i in range(n_layer):
            h = f"h.{i}"
            # Conv1D weights are [in, out]; c_attn's output dim is q|k|v
            # contiguous, so a reshape lands in the stacked [d, 3, d]
            params["blocks"].append({
                "ln_1": ln(f"{h}.ln_1"),
                "attn": {
                    "qkv": leaf(f"{h}.attn.c_attn.weight").reshape(d, 3, d),
                    "qkv_b": leaf(f"{h}.attn.c_attn.bias").reshape(3, d),
                    "proj": leaf(f"{h}.attn.c_proj.weight"),
                    "proj_b": leaf(f"{h}.attn.c_proj.bias"),
                },
                "ln_2": ln(f"{h}.ln_2"),
                "mlp": {
                    "fc": leaf(f"{h}.mlp.c_fc.weight"),
                    "fc_b": leaf(f"{h}.mlp.c_fc.bias"),
                    "proj": leaf(f"{h}.mlp.c_proj.weight"),
                    "proj_b": leaf(f"{h}.mlp.c_proj.bias"),
                },
            })
    return params, cfg


# ----------------------------------------------------------------------- Llama

def _rope_to_interleaved(w_out_in: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Permute a [heads*hd, in] q/k projection from HF's half-rotation RoPE
    layout to the interleaved one: new[2i] = old[i], new[2i+1] =
    old[i + hd/2], per head."""
    out, d_in = w_out_in.shape
    hd = out // n_heads
    w = w_out_in.reshape(n_heads, 2, hd // 2, d_in)
    return w.transpose(1, 2).reshape(out, d_in)


def llama_from_hf(path: str, param_dtype: Optional[torch.dtype] = None, device="cpu",
                  quant: Optional[str] = None, quant_block: Optional[int] = None,
                  **config_overrides):
    """HF Llama checkpoint → ``(params, LlamaConfig)``, the tree on ``device``.

    Parity target: ``AutoModelForCausalLM.from_pretrained(llama)``, the
    reference's SFT/DPO base (``sft_llama2.py:141-154``). GQA, a tied or
    untied ``lm_head``, the RoPE permutation (module doc). With ``quant``
    ('nf4' or 'int8') each leaf is quantized as soon as it is made
    (``quantize_leaf``, block ``quant_block``): the tree equals
    ``quantize_tree`` of the dense one, which never exists whole.
    """
    def finish(t: torch.Tensor) -> Any:
        t = t.contiguous()
        return t if quant is None else quantize_leaf(t, quant, block=quant_block)

    with load_state_dict(path, device) as sd:
        hf_cfg = load_hf_config(path) or {}
        vocab, d = sd.shape("model.embed_tokens.weight")
        n_layer = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("model.layers."))
        d_ff = sd.shape("model.layers.0.mlp.gate_proj.weight")[0]
        kv_out = sd.shape("model.layers.0.self_attn.k_proj.weight")[0]
        n_head = int(hf_cfg.get("num_attention_heads", config_overrides.get("n_head", 32)))
        hd = d // n_head
        cfg_kw = dict(
            vocab_size=vocab, n_layer=n_layer, n_head=n_head, n_kv_head=kv_out // hd,
            d_model=d, d_ff=d_ff,
            n_ctx=int(hf_cfg.get("max_position_embeddings", 4096)),
            rope_theta=float(hf_cfg.get("rope_theta", 10000.0)),
            rms_eps=float(hf_cfg.get("rms_norm_eps", 1e-5)),
        )
        cfg_kw.update(config_overrides)
        if param_dtype is not None:
            cfg_kw["param_dtype"] = param_dtype
        cfg = LlamaConfig(**cfg_kw)
        dt = cfg.param_dtype

        def leaf(name):
            return _as_param(sd[name], dt)

        def linear(name, heads=None):
            # Linear [out, in] → permute the rope channels, then T → [in, out]
            w = leaf(name)
            if heads is not None:
                w = _rope_to_interleaved(w, heads)
            return finish(w.t())

        wte = leaf("model.embed_tokens.weight")
        if "lm_head.weight" in sd and not hf_cfg.get("tie_word_embeddings", False):
            lm_head = finish(leaf("lm_head.weight").t())  # [V, d] -> [d, V]
        else:
            lm_head = finish(wte.t())  # tied embeddings
        params = {"wte": finish(wte), "lm_head": lm_head,
                  "ln_f": {"scale": finish(leaf("model.norm.weight"))}, "blocks": []}
        del wte
        for i in range(n_layer):
            a = f"model.layers.{i}.self_attn"
            m = f"model.layers.{i}.mlp"
            params["blocks"].append({
                "ln_attn": {"scale": finish(leaf(f"model.layers.{i}.input_layernorm.weight"))},
                "attn": {
                    "wq": linear(f"{a}.q_proj.weight", cfg.n_head),
                    "wk": linear(f"{a}.k_proj.weight", cfg.n_kv_head),
                    "wv": linear(f"{a}.v_proj.weight"),
                    "wo": linear(f"{a}.o_proj.weight"),
                },
                "ln_mlp": {"scale": finish(
                    leaf(f"model.layers.{i}.post_attention_layernorm.weight"))},
                "mlp": {
                    "w_gate": linear(f"{m}.gate_proj.weight"),
                    "w_up": linear(f"{m}.up_proj.weight"),
                    "w_down": linear(f"{m}.down_proj.weight"),
                },
            })
    return params, cfg


# our Llama leaf name → (PEFT module path, heads attr for the rope permutation)
_PEFT_MODULES = {
    "wq": ("self_attn.q_proj", "n_head"),
    "wk": ("self_attn.k_proj", "n_kv_head"),
    "wv": ("self_attn.v_proj", None),
    "wo": ("self_attn.o_proj", None),
    "w_gate": ("mlp.gate_proj", None),
    "w_up": ("mlp.up_proj", None),
    "w_down": ("mlp.down_proj", None),
}


def peft_to_lora(path: str, model_cfg: Any, dtype: Optional[torch.dtype] = None,
                 device="cpu") -> tuple:
    """A HF PEFT LoRA checkpoint → ``(adapters, LoraConfig)``, on ``device``.

    The inverse of ``hf_export.lora_to_peft``: ``lora_A.weight`` [r, in] → A
    [in, r], ``lora_B.weight`` [out, r] → B [r, out] with the q/k output rows
    permuted from HF's half-rotation RoPE layout to the interleaved one; a
    PEFT embedding adapter on ``embed_tokens`` becomes the ``wte`` adapter.
    Lets run_sft and run_dpo continue training an adapter made by the
    torch/PEFT stack or by ``--adapter_output``.
    """
    with open(os.path.join(path, "adapter_config.json")) as f:
        pc = json.load(f)
    if pc.get("peft_type") != "LORA":
        raise ValueError(f"not a LoRA adapter: peft_type={pc.get('peft_type')!r}")
    # Scaling variants this importer does not model: rsLoRA rescales
    # alpha/sqrt(r), and rank/alpha_pattern give per-module overrides.
    # Importing one with the plain alpha/r scaling would silently train the
    # adapter at the wrong effective magnitude, so refuse instead.
    if pc.get("use_rslora"):
        raise ValueError(
            "PEFT adapter was trained with use_rslora=True (scaling "
            "alpha/sqrt(r)); this importer applies plain alpha/r scaling and "
            "would be silently wrong. Merge the adapter with PEFT first, or "
            "retrain without rslora."
        )
    for pat in ("rank_pattern", "alpha_pattern"):
        if pc.get(pat):
            raise ValueError(
                f"PEFT adapter sets {pat}={pc[pat]!r} (per-module rank/alpha "
                "overrides); this importer supports a single global r/alpha "
                "only and would import with wrong effective scaling."
            )
    # PEFT names its weight file adapter_model.*, not model.*
    st_path = os.path.join(path, "adapter_model.safetensors")
    sd = (_load_safetensors(st_path, device) if os.path.exists(st_path)
          else _load_torch_bin(os.path.join(path, "adapter_model.bin"), device))
    module_to_ours = {v[0]: (k, v[1]) for k, v in _PEFT_MODULES.items()}
    dt = dtype or torch.float32
    adapters: dict = {}
    with sd:
        for key in sd:
            if key.endswith(".lora_embedding_A"):
                # PEFT Embedding adapter: A [r, V], B [d, r] (transposed vs the
                # Linear convention) on embed_tokens → the gather-side "wte"
                # adapter {A: [V, r], B: [r, d]} (models/lora.lora_embed)
                b_key = key[: -len("lora_embedding_A")] + "lora_embedding_B"
                if b_key not in sd:
                    raise ValueError(
                        f"malformed PEFT checkpoint: {key!r} has no paired {b_key!r}")
                adapters["wte"] = {"A": _as_param(sd[key], dt).t().contiguous(),
                                   "B": _as_param(sd[b_key], dt).t().contiguous()}
                continue
            if not key.endswith(".lora_A.weight"):
                continue
            stem = key[: -len(".lora_A.weight")]
            b_key = stem + ".lora_B.weight"
            if b_key not in sd:
                raise ValueError(
                    f"malformed PEFT checkpoint: {key!r} has no paired {b_key!r}"
                )
            # stem like base_model.model.model.layers.3.self_attn.q_proj
            parts = stem.split(".")
            layer = parts[parts.index("layers") + 1]
            module = ".".join(parts[parts.index("layers") + 2:])
            if module not in module_to_ours:
                raise ValueError(f"unsupported PEFT target module {module!r}")
            ours, heads_attr = module_to_ours[module]
            A = _as_param(sd[key], dt).t()                 # [in, r]
            B = _as_param(sd[b_key], dt)                   # [out, r]
            if heads_attr is not None:
                B = _rope_to_interleaved(B, int(getattr(model_cfg, heads_attr)))
            group = "attn" if ours in ("wq", "wk", "wv", "wo") else "mlp"
            adapters[f"blocks/{layer}/{group}/{ours}"] = {
                "A": A.contiguous(), "B": B.t().contiguous()}  # B: [r, out]
    if not adapters:
        raise ValueError(f"no lora_A/lora_B pairs found under {path!r}")
    lcfg = LoraConfig(r=int(pc["r"]), alpha=int(pc["lora_alpha"]),
                      target_patterns=tuple(sorted({p.split("/")[-1] for p in adapters})))
    return adapters, lcfg


def detect_family(path: str) -> str:
    """'gpt2' | 'llama' from config.json, else from the tensor names (read
    from the headers alone)."""
    hf_cfg = load_hf_config(path)
    if hf_cfg:
        mt = hf_cfg.get("model_type", "")
        if mt in ("gpt2",):
            return "gpt2"
        if mt in ("llama", "mistral"):
            return "llama"
    with load_state_dict(path) as sd:
        keys = list(sd)
    if any("embed_tokens" in k for k in keys):
        return "llama"
    if any(k.endswith("wte.weight") for k in keys):
        return "gpt2"
    raise ValueError(f"cannot detect model family of checkpoint at {path!r}")
