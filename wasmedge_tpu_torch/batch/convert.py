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
    SIMD_FIELDS, BatchState, resolve_device)
from wasmedge_tpu_torch.batch.image import DeviceImage


def image_from_reference(planes: dict, scalars: dict) -> DeviceImage:
    """`planes`: the reference image's numpy fields by name
    (DeviceImage.NUMPY_FIELDS, the `v128` table included); `scalars`: its
    mem_pages_init, mem_pages_max, has_memory, max_local_zeros, code_len
    and has_simd.  An image
    with import stubs comes across whole (code_len counts the stubs);
    the reference's tier-0 `t0kind` plane is not a field here and is
    ignored, since this port parks every host call at its stub."""
    kw = {}
    for f in DeviceImage.NUMPY_FIELDS:
        kw[f] = np.ascontiguousarray(planes[f], np.int32).copy()
    kw["br_table"] = kw["br_table"].reshape(-1, 3)
    kw["v128"] = kw["v128"].reshape(-1, 4)
    for f in DeviceImage.SCALAR_FIELDS:
        v = scalars[f]
        kw[f] = bool(v) if f in ("has_memory", "has_simd") else int(v)
    if kw["code_len"] != kw["cls"].shape[0]:
        raise ValueError(f"code_len {kw['code_len']} != "
                         f"{kw['cls'].shape[0]} code cells")
    return DeviceImage(**kw)


def state_from_reference(planes: dict, device="cuda") -> BatchState:
    """`planes`: the reference BatchState's fields as numpy arrays (at
    least BatchState.FIELDS; `stack_e2` / `stack_e3` are None or absent
    for images without v128 ops, and optional planes this slice does not
    use must be absent or None)."""
    for f, v in planes.items():
        if f not in BatchState.FIELDS and v is not None:
            raise ValueError(f"state plane {f} is not used by this slice")
    L = np.asarray(planes["pc"]).shape[0]
    for f in BatchState.FIELDS:
        if planes.get(f) is None:
            if f in SIMD_FIELDS:
                continue
            raise ValueError(f"state plane {f} is missing")
        p = np.asarray(planes[f])
        if p.shape[-1] != L:
            raise ValueError(f"{f} has {p.shape[-1]} lanes, expected {L}")
    return BatchState.from_numpy(planes, resolve_device(device))
