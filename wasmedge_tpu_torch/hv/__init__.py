"""Lane-memory virtualization, the parts the port has so far.

`swapstore.py` is a copy of `wasmedge_tpu/hv/swapstore.py`'s store and
column serializer: a content-addressed, refcounted host store with
crash-atomic disk mirrors and an end-to-end hash check.  The image
store's pre-initialized snapshots keep their columns in it
(imagestore/snapshot.py).  The virtualizer itself (the policy and the
manager that swap lanes in and out of a server) is ROADMAP A7.3.
"""

from wasmedge_tpu_torch.hv.swapstore import (  # noqa: F401
    SwapCorrupt,
    SwapStore,
    deserialize_columns,
    serialize_columns,
)
