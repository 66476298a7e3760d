"""The port stands alone: no module of ``distributed_lion_tpu_torch``, and
not ``chip_smoke.py``, imports ``jax`` or anything of the JAX package, and
importing every port module leaves both out of ``sys.modules``."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_lion_tpu_torch"
FORBIDDEN = ("jax", "distributed_lion_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_port_file_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert not offenders, offenders
    assert len(_port_files()) > 20


def test_importing_every_port_module_loads_no_jax():
    modules = ["distributed_lion_tpu_torch." + ".".join(
        p.relative_to(PORT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'distributed_lion_tpu' or m.startswith('distributed_lion_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_sft_slice_modules_are_among_the_checked_files():
    """The SFT slice's modules (quantization, LoRA, Llama, the SFT data and
    CLI) are in the file list both checks above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"ops/quant.py", "models/lora.py", "models/llama.py", "data/tokenizer.py",
            "data/packing.py", "data/sft.py", "cli/run_sft.py"} <= files


def test_the_checkpoint_and_data_modules_are_among_the_checked_files():
    """The checkpoint and data-path modules (resilience, the checkpointer,
    GPT-2 BPE, the native build and loader) are in the file list both
    checks above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"train/resilience.py", "train/checkpoint.py", "data/bpe.py",
            "data/native_loader.py", "data/sources.py", "native/__init__.py"} <= files


def test_the_optimizer_modes_modules_are_among_the_checked_files():
    """The AdamW baseline's module, beside the optimizer modules lazy
    refresh and ``mom_dtype`` changed, is in the file list both checks
    above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"optim/optax_adapter.py", "optim/distributed_lion.py", "optim/lion.py",
            "ops/lion_math.py", "train/telemetry.py", "train/loop.py"} <= files


def test_the_dpo_modules_are_among_the_checked_files():
    """The DPO slice's modules (its data, its loss and its CLI) are in the
    file list both checks above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"data/dpo.py", "train/dpo.py", "cli/run_dpo.py"} <= files


def test_the_chunked_vocabulary_modules_are_among_the_checked_files():
    """The chunked-vocabulary cross entropy and the modules that call it
    (the trainer, DPO's scoring, the trainable Llama, the three CLIs) are in
    the file list both checks above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"ops/xent.py", "ops/products.py", "train/loop.py", "train/dpo.py",
            "models/llama.py", "cli/run_clm.py", "cli/run_sft.py", "cli/run_dpo.py",
            "utils/serialization.py"} <= files


CARD_LACKS = ("safetensors", "transformers", "tokenizers", "sentencepiece")


def test_no_port_file_imports_what_the_gpu_machine_lacks():
    """The HF import and export read and write safetensors themselves and
    the tokenizers read their files themselves: no port file imports
    ``safetensors``, ``transformers``, ``tokenizers`` or ``sentencepiece``
    (the GPU machine has none of them), and importing every port module
    loads none of them."""
    offenders = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                          if n.split(".")[0] in CARD_LACKS]
    assert not offenders, offenders
    modules = ["distributed_lion_tpu_torch." + ".".join(
        p.relative_to(PORT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {CARD_LACKS!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_hf_checkpoint_modules_are_among_the_checked_files():
    """The HF import and export, the SentencePiece and tokenizer.json
    readers and the tokenizer dispatch are in the file list the checks
    above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"models/hf_import.py", "models/hf_export.py", "data/spm.py",
            "data/hf_tokenizer_json.py", "data/tokenizer.py"} <= files


def test_the_guard_sentinel_and_profiler_modules_are_among_the_checked_files():
    """The vote guard's machine, the profiler and the modules the guard,
    the sentinel and preemption changed (the wire, the optimizer, the
    crash bundle, the poison parser and the preemption flag, the trainer)
    are in the file list the checks above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"train/vote_guard.py", "train/profiling.py", "train/resilience.py",
            "train/telemetry.py", "parallel/collectives.py", "optim/distributed_lion.py",
            "optim/lion.py", "train/loop.py"} <= files


def test_the_journal_and_control_plane_modules_are_among_the_checked_files():
    """The run journal, its analyzer and the control plane (stdlib and
    numpy copies of the JAX package's modules, which the port must not
    import) and the modules that now journal (the metrics logger, the
    checkpointer, the data path) are in the file list the checks above
    walk, and none of them loads the JAX package's module of the same
    name."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    new = {"train/journal.py", "cli/run_analyze.py", "train/control_plane.py"}
    assert new | {"train/metrics.py", "train/checkpoint.py", "data/native_loader.py",
                  "data/tokenizer.py"} <= files
    for rel in new:
        tree = ast.parse((PORT / rel).read_text())
        imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                    for a in n.names}
        imported |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        allowed = ("distributed_lion_tpu_torch", "__future__", "numpy")
        assert all(m.split(".")[0] in allowed or m.split(".")[0] in sys.stdlib_module_names
                   for m in imported), (rel, imported)


def test_the_zero1_and_dcn_pipeline_modules_are_among_the_checked_files():
    """ZeRO-1 (``optim/zero.py``, a copy of the JAX module's math, which the
    port must not import) and the modules the DCN pipeline changed (the
    codec's ring sizes, the wire's launch and consume, the ring in the
    state, the optimizer, the fault registry, the trainer) are in the file
    list the checks above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"optim/zero.py", "ops/codec.py", "parallel/collectives.py", "optim/lion.py",
            "optim/distributed_lion.py", "train/resilience.py", "train/loop.py"} <= files
    tree = ast.parse((PORT / "optim/zero.py").read_text())
    imported = {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    imported |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert all(m.split(".")[0] in ("distributed_lion_tpu_torch", "__future__", "torch")
               or m.split(".")[0] in sys.stdlib_module_names for m in imported), imported


def test_the_tensor_parallel_modules_are_among_the_checked_files():
    """The tensor axis's module, beside every module the tensor-parallel
    slice touched (the grid, the models, the losses, LoRA, NF4, the
    converters, the trainer, the CLIs), is in the file list both checks
    above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"parallel/tensor_parallel.py", "parallel/mesh.py", "parallel/collectives.py",
            "models/gpt2.py", "models/llama.py", "models/lora.py", "ops/xent.py",
            "ops/quant.py", "utils/serialization.py", "train/loop.py", "train/dpo.py",
            "cli/run_clm.py", "cli/run_sft.py", "cli/run_dpo.py"} <= files


def test_the_sequence_parallel_modules_are_among_the_checked_files():
    """The seq axis's module, beside every module the sequence-parallel
    slice touched (the grid, the models, the losses, the trainer, DPO's
    logprobs, the CLIs), is in the file list both checks above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"parallel/ring_attention.py", "parallel/mesh.py", "models/gpt2.py",
            "models/llama.py", "models/loss.py", "ops/xent.py", "train/loop.py",
            "train/dpo.py", "utils/argparsing.py", "cli/run_clm.py", "cli/run_sft.py",
            "cli/run_dpo.py"} <= files


def test_the_expert_parallel_modules_are_among_the_checked_files():
    """The expert axis's module, beside every module the expert-parallel
    slice touched (the grid, the tensor split rules, GPT-2, the losses, the
    optimizer state, the trainer, the converters, the CLI), is in the file
    list both checks above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"parallel/expert.py", "parallel/mesh.py", "parallel/tensor_parallel.py",
            "models/gpt2.py", "models/loss.py", "optim/lion.py", "train/loop.py",
            "utils/serialization.py", "cli/run_clm.py"} <= files


def test_the_pipeline_modules_are_among_the_checked_files():
    """The pipe axis's modules and the standalone optimizer step, beside
    every module the pipeline slice touched (the grid, the models and their
    loss, the trainer, the converters, the CLI), are in the file list both
    checks above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"parallel/pipeline.py", "models/gpt2_pipe.py", "models/llama_pipe.py",
            "optim/sharded.py", "parallel/mesh.py", "models/llama.py", "models/loss.py",
            "train/loop.py", "utils/serialization.py", "cli/run_clm.py"} <= files


def test_the_generation_modules_are_among_the_checked_files():
    """Dense-cache generation (``models/generate.py``, ``cli/run_generate.py``),
    beside every module its slice touched (the decode paths of both models,
    MoE's inference arguments, the list flags of the CLI parser) and the
    chunked trainer and mixed-dtype optimizer, is in the file list both
    checks above walk."""
    files = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"models/generate.py", "cli/run_generate.py", "models/gpt2.py", "models/llama.py",
            "parallel/expert.py", "utils/argparsing.py", "train/loop.py", "optim/lion.py",
            "optim/distributed_lion.py"} <= files
