"""Serving: continuous batching over a paged KV cache (port of
``distributed_lion_tpu/serve/``, one device).

- ``kv_cache`` — the host's page allocator, block tables and prefix cache;
  the device pool's primitives live in ``ops.attention``
- ``engine``   — admission, bucketed prefill and the decode tick
- ``metrics``  — request-lifecycle clocks, latency sketches, the SLO monitor
- ``api``      — the request-file front end

Speculation, tensor- and expert-parallel serving (ROADMAP Queue 1 item
12(d)) and the fleet (item 12(e)) are still to port.
"""

from distributed_lion_tpu_torch.serve.engine import (  # noqa: F401
    Completion,
    RecoveryRecord,
    Request,
    ServeConfig,
    ServeModel,
    ServingEngine,
)
from distributed_lion_tpu_torch.serve.kv_cache import BlockTables, init_pages  # noqa: F401
