"""Carry an image and a lane state across from the reference package.

The reference's `DeviceImage` and `BatchState` are the system's "weights":
the code tables a module lowers to and the per-lane state an interpreter
run starts from.  These functions take them as plain numpy arrays and
dicts (never reference objects), so that the tests can feed the
identical image and initial state to both packages and compare every
plane afterwards.
"""

from __future__ import annotations

import numpy as np

from wasmedge_tpu_torch.batch.engine import (
    OPTIONAL_FIELDS, BatchState, resolve_device)
from wasmedge_tpu_torch.batch.image import CLS_MEMGROW, DeviceImage


def image_from_reference(planes: dict, scalars: dict) -> DeviceImage:
    """`planes`: the reference image's numpy fields by name
    (DeviceImage.NUMPY_FIELDS, the `v128` table and the segment
    snapshots included); `scalars`: its DeviceImage.SCALAR_FIELDS (the
    table's declared maximum, capacity, initial size and mutation flags
    included).  An image
    with import stubs comes across whole (code_len counts the stubs);
    the reference's tier-0 `t0kind` plane is not a field here and is
    ignored, since this port parks every host call at its stub.  The `b`
    of each memory.grow takes the image's `mem_pages_max`, the ceiling
    the reference's grow reads."""
    kw = {}
    for f in DeviceImage.NUMPY_FIELDS:
        kw[f] = np.ascontiguousarray(planes[f], np.int32).copy()
    kw["br_table"] = kw["br_table"].reshape(-1, 3)
    kw["v128"] = kw["v128"].reshape(-1, 4)
    for f in DeviceImage.SCALAR_FIELDS:
        v = scalars[f]
        kw[f] = bool(v) if f in DeviceImage.BOOL_FIELDS else int(v)
    if kw["code_len"] != kw["cls"].shape[0]:
        raise ValueError(f"code_len {kw['code_len']} != "
                         f"{kw['cls'].shape[0]} code cells")
    # memory.grow reads its page ceiling from its `b` here, the reference
    # from the image-wide mem_pages_max
    kw["b"][kw["cls"] == CLS_MEMGROW] = kw["mem_pages_max"]
    return DeviceImage(**kw)


def state_from_reference(planes: dict, device="cuda") -> BatchState:
    """`planes`: the reference BatchState's fields as numpy arrays (at
    least BatchState.FIELDS; `stack_e2` / `stack_e3` are None or absent
    for images without v128 ops, the tier-0 planes `t0_ctr`, `so_buf`
    and `so_off` when tier 0 is off, and optional planes this slice does
    not use must be absent or None)."""
    for f, v in planes.items():
        if f not in BatchState.FIELDS and v is not None:
            raise ValueError(f"state plane {f} is not used by this slice")
    L = np.asarray(planes["pc"]).shape[0]
    for f in BatchState.FIELDS:
        if planes.get(f) is None:
            if f in OPTIONAL_FIELDS:
                continue
            raise ValueError(f"state plane {f} is missing")
        p = np.asarray(planes[f])
        if p.shape[-1] != L:
            raise ValueError(f"{f} has {p.shape[-1]} lanes, expected {L}")
    return BatchState.from_numpy(planes, resolve_device(device))
