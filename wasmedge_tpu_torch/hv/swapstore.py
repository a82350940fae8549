"""Host-side content-addressed store and the named-column serializer.

A copy of `wasmedge_tpu/hv/swapstore.py`'s `SwapStore` and
`serialize_columns` / `deserialize_columns`.  The store keys payloads by
content (sha256), keeps them in memory and, given a directory, mirrors
them to disk through `utils/fsio.atomic_write_bytes`, so a crash mid-write
never leaves a truncated blob.  `get()` re-hashes a payload against its
key and raises `SwapCorrupt` on any mismatch (bit rot, a torn write, a
crafted file): the caller decides whether that is a skip (a snapshot
falls back to template init) or a rejected request.

Left out: the per-lane serializer (`lane_plane_names`, `serialize_lanes`,
`deserialize_lane`) and `adopt` (a checkpoint's embedded blobs), which
come with the lane virtualizer (ROADMAP A7.3), and the scrub methods
(`scrub_*`, `peek`), which come with the integrity scrubber (A7.5).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from wasmedge_tpu_torch.utils.fsio import atomic_write_bytes


class SwapCorrupt(RuntimeError):
    """A stored payload failed its content-hash check (or is missing): the
    state it held is unrecoverable."""

    def __init__(self, key: str, reason: str):
        super().__init__(f"swap entry {key[:12]}... corrupt: {reason}")
        self.key = key
        self.reason = reason


class SwapStore:
    """Content-addressed, refcounted host store.

    `faults` is an optional testing.faults.FaultInjector: `put()` fires
    the `swap_store_write` seam before any bytes move, so an injected
    store failure leaves neither a memory entry nor a disk file."""

    def __init__(self, dir: Optional[str] = None, faults=None):
        self.dir = os.fspath(dir) if dir else None
        self.faults = faults
        self._mem: Dict[str, bytes] = {}
        self._refs: Dict[str, int] = {}
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self._mem)

    @staticmethod
    def key_of(payload: bytes) -> str:
        return hashlib.sha256(payload).hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.lane")

    def put(self, payload: bytes) -> str:
        """Store one payload; returns its content key.  An identical
        payload shares the entry; the refcount tracks owners."""
        key = self.key_of(payload)
        if self.faults is not None:
            self.faults.fire("swap_store_write", key=key,
                             nbytes=len(payload))
        if key not in self._mem:
            self._mem[key] = bytes(payload)
            if self.dir:
                atomic_write_bytes(self._path(key), payload)
        self._refs[key] = self._refs.get(key, 0) + 1
        return key

    def get(self, key: str) -> bytes:
        """Fetch and verify one payload; raises SwapCorrupt on a hash
        mismatch or a missing entry."""
        payload = self._mem.get(key)
        if payload is None and self.dir:
            try:
                with open(self._path(key), "rb") as f:
                    payload = f.read()
            except OSError as e:
                raise SwapCorrupt(key, f"unreadable: {e}") from e
        if payload is None:
            raise SwapCorrupt(key, "missing entry")
        if self.key_of(payload) != key:
            raise SwapCorrupt(key, "content hash mismatch")
        return payload

    def release(self, key: str):
        """Drop one reference; the entry (and its disk mirror) goes with
        the last one.  Unknown keys are a no-op."""
        n = self._refs.get(key)
        if n is None:
            return
        if n > 1:
            self._refs[key] = n - 1
            return
        self._refs.pop(key, None)
        self._mem.pop(key, None)
        if self.dir:
            try:
                os.unlink(self._path(key))
            except OSError:
                pass


def serialize_columns(cols: Dict[str, np.ndarray],
                      meta: Optional[dict] = None) -> bytes:
    """Named columns and JSON side-meta -> one compressed npz payload (the
    JAX package's envelope, so either package reads the other's)."""
    arrays = {f"p_{name}": np.ascontiguousarray(arr)
              for name, arr in cols.items()}
    m = dict(meta or {})
    m["planes"] = sorted(cols)
    buf = io.BytesIO()
    np.savez_compressed(buf, meta=json.dumps(m), **arrays)
    return buf.getvalue()


def deserialize_columns(payload: bytes
                        ) -> Tuple[Dict[str, np.ndarray], dict]:
    """Payload bytes -> ({name: array}, meta dict)."""
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        cols = {name: z[f"p_{name}"] for name in meta["planes"]}
    return cols, meta
