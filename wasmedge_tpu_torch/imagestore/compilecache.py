"""The gateway's lowering cache, its probe tier.

A copy of the probe tier of `wasmedge_tpu/imagestore/compilecache.py`:
the rejected-registration stash.  A `RegisteredModule` whose registration
was rolled back after its lowering succeeded (a failed or timed-out
generation build) is parked here under the sha256 of its bytes, so that a
re-POST of the same bytes adopts its engine instead of lowering again
(the registry's `lowered_count` stays where it was).

The persistent tier (aot image payloads on disk that survive a restart)
needs the ahead-of-time image format and the validator's precompiled
path, which the port does not have yet (ROADMAP A7.7): `enabled` is
always False and `enable()` raises.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict

# probe-tier depth: each entry pins an instantiated module and two sink
# fds, so keep it small
PROBE_DEPTH = 4


class CompileCache:
    """Content-addressed stash of rolled-back registrations."""

    def __init__(self, faults=None):
        self.faults = faults
        self._lock = threading.Lock()
        self._probe: "OrderedDict[str, object]" = OrderedDict()
        self.counts: Dict[str, int] = {"probe_hits": 0}

    @property
    def enabled(self) -> bool:
        """Whether the persistent tier is on: never, in the port."""
        return False

    def enable(self, dir=None) -> None:
        raise NotImplementedError(
            "the persistent compile cache is not in the port yet "
            "(ROADMAP A7.7: it needs the aot image format)")

    def pop_probe(self, sha: str):
        """Adopt and remove a stashed RegisteredModule for these exact
        bytes (None: no probe)."""
        with self._lock:
            rm = self._probe.pop(sha, None)
        if rm is not None:
            self.counts["probe_hits"] += 1
        return rm

    def stash_probe(self, sha: str, rm) -> None:
        """Park a rolled-back module's lowered engine for a re-POST of the
        same bytes; displaced and evicted entries close (their sink fds
        must not leak)."""
        with self._lock:
            displaced = self._probe.pop(sha, None)
            self._probe[sha] = rm
            evicted = []
            while len(self._probe) > PROBE_DEPTH:
                evicted.append(self._probe.popitem(last=False))
        if displaced is not None:
            displaced.close()
        for _, old in evicted:
            old.close()

    def close(self) -> None:
        with self._lock:
            probes = list(self._probe.values())
            self._probe.clear()
        for rm in probes:
            rm.close()

    def stats(self) -> dict:
        with self._lock:
            depth = len(self._probe)
        return dict(self.counts, enabled=False, probe_entries=depth)
