"""distributed_lion_tpu_torch — the PyTorch/CUDA port of ``distributed_lion_tpu``.

Majority-vote Lion (1-bit sign ballots, one vote collective per bucket,
rank-local momentum) for NVIDIA Hopper. Module paths mirror the JAX
package, which stays the reference: ``optim/distributed_lion.py`` here
ports ``distributed_lion_tpu/optim/distributed_lion.py``. The one renamed
module is ``ops/fused_lion.py``, which holds the hand-written Triton
kernels that replace ``ops/pallas_lion.py``.

The port imports ``torch`` and numpy only, never ``jax`` and nothing of the
JAX package. Entry points run on the card unless the caller asks for the
CPU (``device="cpu"``, or ``DLION_PLATFORM=cpu`` for the CLI).
"""
