"""Per-module segment memoization for concatenated device images.

A copy of `wasmedge_tpu/imagestore/segments.py`.  `batch/multitenant.py`
`concat_images` builds one `Segment` per tenant, a pure function of the
tenant's DeviceImage and its index-space offsets.  This cache keys on
exactly those inputs, so a generation rebuilt after module N+1 registers
replays modules 1..N's segments verbatim and rebases only the newcomer.
The key is the image's content fingerprint (`batch/image.py`
`image_fingerprint`) and its offsets; the JAX key's third part, the fuse
patterns merged before the tenant, has no counterpart in the port (it has
no memfuse planner), so it is left out.  An entry pins the image object,
which keeps the segment's arrays alive as long as the engine that made
them.
"""

from __future__ import annotations

from collections import OrderedDict

from wasmedge_tpu_torch.batch.image import image_fingerprint

# every registered module of a deep gateway plus a couple of generations
# being rebuilt; LRU beyond that (a miss just rebuilds)
_DEFAULT_DEPTH = 64

_OFF_KEYS = ("pc", "func", "glob", "type", "brt", "table", "v128",
             "eseg", "eflat", "dseg", "dbyte")


class SegmentCache:
    """LRU of rebased image segments keyed by (image content, offsets)."""

    def __init__(self, depth: int = _DEFAULT_DEPTH):
        self.depth = int(depth)
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.builds = 0

    @staticmethod
    def _key(img, off: dict):
        return image_fingerprint(img), tuple(off[k] for k in _OFF_KEYS)

    def lookup(self, img, off: dict):
        key = self._key(img, off)
        ent = self._entries.get(key)
        if ent is None:
            return None
        cached_img, seg = ent
        if cached_img is not img:
            # equal content at equal offsets from another image object:
            # the segment is still valid; pin the newer image
            self._entries[key] = (img, seg)
        self._entries.move_to_end(key)
        self.hits += 1
        return seg

    def store(self, img, off: dict, seg) -> None:
        key = self._key(img, off)
        self._entries[key] = (img, seg)
        self._entries.move_to_end(key)
        self.builds += 1
        while len(self._entries) > self.depth:
            self._entries.popitem(last=False)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "builds": self.builds}
