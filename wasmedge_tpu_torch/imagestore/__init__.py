"""The image store: segmented generation images, the rejected-registration
stash, and pre-initialized lane snapshots.

A copy of the parts of `wasmedge_tpu/imagestore/` that a gateway
generation needs, gated through `Configure.imagestore` (every default off
concatenates each segment inline and admits through template init):

- `segments.SegmentCache` keeps rebased image segments, so registering
  module N+1 builds one new segment and a generation swap replays the
  rest;
- `compilecache.CompileCache` is the probe tier only: the stash of
  rolled-back registrations that a re-POST of the same bytes adopts (the
  persistent tier is ROADMAP A7.7);
- `snapshot` runs a module's init once at registration and admits its
  lanes from the captured columns (`init_overlays`).
"""

from wasmedge_tpu_torch.imagestore.compilecache import CompileCache
from wasmedge_tpu_torch.imagestore.segments import SegmentCache
from wasmedge_tpu_torch.imagestore.snapshot import (
    SnapshotEntry,
    capture_snapshot,
    decode_overlay,
    init_export_of,
)

__all__ = [
    "CompileCache",
    "SegmentCache",
    "SnapshotEntry",
    "capture_snapshot",
    "decode_overlay",
    "init_export_of",
]
