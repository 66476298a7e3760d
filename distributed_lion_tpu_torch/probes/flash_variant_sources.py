"""Probe helper: write design variants of the flash kernels as source trees.

    python -m distributed_lion_tpu_torch.probes.flash_variant_sources OUT [NAME ...]

Writes ``OUT/change/`` (the tree's ``csrc/flash_attention.cu`` and
``csrc/hopper.cuh``) and, for each variant of ``VARIANTS`` (all, or those
named), ``OUT/<name>/`` made from the tree's sources by exact string
replacements, each of which must match where it is expected. Then
``probes/flash_variants.py`` builds and times them side by side:

    python -m distributed_lion_tpu_torch.probes.flash_variants OUT/parent OUT/change OUT/st2 ...

with ``OUT/parent/`` a parent's ``csrc/`` unpacked by ``git archive``.
"""

import pathlib
import sys

from distributed_lion_tpu_torch.ops import cuda_build

SOURCES = ("flash_attention.cu", "hopper.cuh")

# name -> (what it tries, [(file, old, new, times old occurs)]); a name
# joined by "+" applies each part's replacements in turn
VARIANTS = {
    "headmajor": ("the forward's grid head-major (b*h as blockIdx.x)", [
        ("flash_attention.cu",
         "  const int bh = blockIdx.y * group + blockIdx.x % group, b = bh / H, h = bh % H;\n"
         "  const int tile = tiles - 1 - blockIdx.x / group, q0",
         "  const int bh = blockIdx.x, b = bh / H, h = bh % H;\n"
         "  const int tile = gridDim.y - 1 - blockIdx.y, q0", 1),
        ("flash_attention.cu", "const dim3 grid(tiles * group, B * H / group);",
         "const dim3 grid(B * H, tiles);", 1)]),
    **{f"group{g}": ("the forward's grid tile-major by head, without groups" if g == 1 else
                     f"the forward's blocks in groups of {g} heads, longest tiles first", [
        ("flash_attention.cu", "constexpr int FWD_HEAD_GROUP = 16;",
         f"constexpr int FWD_HEAD_GROUP = {g};", 1)]) for g in (1, 8, 32)},
    "st3": ("three stages in each of the forward's rings at head_dim 128", [
        ("flash_attention.cu", "  static constexpr int STAGES = 2;\n  static constexpr int TILE = FWD_BN",
         "  static constexpr int STAGES = D == 64 ? 2 : 3;\n  static constexpr int TILE = FWD_BN", 1)]),
    "maskselect": ("the forward's diagonal mask as a select on every tile", [
        ("flash_attention.cu",
         "  if (diag) {\n#pragma unroll\n    for (int i = 0; i < 64; ++i) {\n"
         "      const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);\n"
         "      S[i] = c <= r + 8 * ((i / 2) % 2) ? S[i] : -INFINITY;\n    }\n  }",
         "  const int last[2] = {diag ? r : FWD_BN, diag ? r + 8 : FWD_BN};\n#pragma unroll\n"
         "  for (int i = 0; i < 64; ++i) {\n"
         "    const int c = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);\n"
         "    S[i] = c <= last[(i / 2) % 2] ? S[i] : -INFINITY;\n  }", 1)]),
    "fwd240": ("the 24/240 register split in the forward", [
        ("flash_attention.cu", "    hopper::setmaxnreg_dec<PRODUCER_REGS>();\n"
         "    if (threadIdx.x == 0) {\n      auto load",
         "    hopper::setmaxnreg_dec<24>();\n    if (threadIdx.x == 0) {\n      auto load", 1),
        ("flash_attention.cu", "    hopper::setmaxnreg_inc<CONSUMER_REGS>();\n"
         "    fwd_consume_overlapped<D>",
         "    hopper::setmaxnreg_inc<240>();\n    fwd_consume_overlapped<D>", 1)]),
    "trap": ("the forward's consumers wait with the watchdog's trap path (mbar_wait)", [
        ("flash_attention.cu", "  hopper::mbar_wait_spin(q_full, 0);",
         "  hopper::mbar_wait(q_full, 0);", 1),
        ("flash_attention.cu", "hopper::mbar_wait_spin(&full[s], (j / STAGES) & 1);\n"
         "    hopper::wgmma_fence();",
         "hopper::mbar_wait(&full[s], (j / STAGES) & 1);\n    hopper::wgmma_fence();", 1),
        ("flash_attention.cu", "hopper::mbar_wait_spin(&v_full[", "hopper::mbar_wait(&v_full[", 2)]),
    "noq0": ("the Q load's row passed as tile * FWD_BM in place of q0 (the same arithmetic)", [
        ("flash_attention.cu", "const int tile = tiles - 1 - blockIdx.x / group, q0 = tile * FWD_BM;",
         "const int tile = tiles - 1 - blockIdx.x / group;", 1),
        ("flash_attention.cu", "FWD_BM, q0, h, b);", "FWD_BM, tile * FWD_BM, h, b);", 1)]),
    **{f"di_threads{n}": (f"the di kernel with blocks of {n} threads", [
        ("flash_attention.cu", "constexpr int DI_THREADS = 256;",
         f"constexpr int DI_THREADS = {n};", 1)]) for n in (128, 512)},
    "di_ldg": ("the di kernel's loads through the read-only path (__ldg) instead of streaming", [
        ("flash_attention.cu", "__ldcs(", "__ldg(", 2)]),
}


def write(out: pathlib.Path, names) -> list:
    """The variant trees under ``out``; returns their directories."""
    tree = {f: (cuda_build.CSRC / f).read_text() for f in SOURCES}
    dirs = []
    for name in ["change", *names]:
        files = dict(tree)
        edits = [e for part in name.split("+") if name != "change" for e in VARIANTS[part][1]]
        for f, old, new, times in edits:
            if files[f].count(old) != times:
                raise ValueError(f"variant {name}: {old!r} occurs {files[f].count(old)} times "
                                 f"in {f}, expected {times}")
            files[f] = files[f].replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        dirs.append(d)
        what = "; ".join(VARIANTS[part][0] for part in name.split("+")) if name != "change" \
            else "the tree"
        print(f"[variant] {d}: {what}")
    return dirs


def main() -> int:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    write(pathlib.Path(sys.argv[1]), sys.argv[2:] or list(VARIANTS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
