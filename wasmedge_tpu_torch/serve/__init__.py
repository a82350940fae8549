"""Continuous-batching serving layer.

`BatchServer` turns the drain-to-empty batch engines into a long-lived
service: a bounded request queue with per-tenant weighted-fair
admission, lane recycling at launch boundaries, and deadline and
backpressure enforcement.  See serve/server.py.
"""

from wasmedge_tpu_torch.serve.queue import (  # noqa: F401
    DeadlineExceeded,
    FairQueue,
    QueueSaturated,
    ServeFuture,
    ServeRequest,
)
from wasmedge_tpu_torch.serve.recycle import LaneRecycler  # noqa: F401
from wasmedge_tpu_torch.serve.server import BatchServer  # noqa: F401
