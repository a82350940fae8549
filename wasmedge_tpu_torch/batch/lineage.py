"""Shared checkpoint-lineage machinery.

A copy of `wasmedge_tpu/batch/lineage.py`.  BatchSupervisor
(batch/supervisor.py) and BatchServer (serve/server.py) both keep a
bounded, ordered list of snapshot members and apply the same moves to
it: adopt an existing directory at startup, walk newest-first on restore
while recording and dropping corrupt members, replace-or-append an entry
at an unchanged position, and prune members beyond a keep depth.  The
member *payload* (the server's lane->request binding snapshot) rides
along opaquely.

The lineage itself is storage-agnostic: members are (path, steps,
payload) and loading and validation stay with the caller (invocation
binding, fault-injection seams and engine geometry checks differ per
consumer), passed in as the `load` callback of `walk_newest`.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass
class Member:
    """One lineage member: a snapshot path, its execution cursor, and an
    opaque consumer payload (None for the supervisor's plain members)."""

    path: str
    steps: int
    payload: object = None


class Lineage:
    """Bounded newest-last list of checkpoint members."""

    def __init__(self):
        self.members: List[Member] = []

    def __len__(self) -> int:
        return len(self.members)

    def __bool__(self) -> bool:
        return bool(self.members)

    def newest(self) -> Optional[Member]:
        return self.members[-1] if self.members else None

    def next_seq(self) -> int:
        """The cursor one past the newest member's: snapshot consumers
        whose members are plain sequence-numbered files allocate their
        next filename from it."""
        m = self.newest()
        return (m.steps + 1) if m is not None else 0

    def reset(self):
        """Drop every member (a fresh run must never inherit a previous
        run()'s lineage; only an explicit resume adopts disk state)."""
        self.members = []

    # -- directory adoption ------------------------------------------------
    @staticmethod
    def scan(dirpath: Optional[str], pattern: str) -> List[Tuple[str, int]]:
        """Member candidates on disk: entries of `dirpath` whose name
        fullmatches `pattern` (one int group = the steps cursor), sorted
        oldest-first by that cursor.  Missing directory -> []."""
        if not dirpath or not os.path.isdir(dirpath):
            return []
        out = []
        for fn in sorted(os.listdir(dirpath)):
            m = re.fullmatch(pattern, fn)
            if m:
                out.append((os.path.join(dirpath, fn), int(m.group(1))))
        out.sort(key=lambda t: t[1])
        return out

    def install(self, scanned: List[Tuple[str, int]]):
        """Replace the lineage with scanned (path, steps) candidates."""
        self.members = [Member(p, s) for p, s in scanned]

    # -- growth / pruning --------------------------------------------------
    def add(self, path: str, steps: int, payload=None):
        """Append a member — or replace the newest one in place when it
        has the same path (an on-demand re-snapshot at an unchanged
        cursor must not stack duplicate entries the prune pass would
        unlink while survivors still reference the file)."""
        m = Member(path, int(steps), payload)
        if self.members and self.members[-1].path == path:
            self.members[-1] = m
        else:
            self.members.append(m)

    def prune(self, keep: int, unlink: Callable[[str], None] = os.unlink):
        """Drop (and best-effort delete) members beyond the newest
        `keep`; a failed delete never fails the run."""
        while len(self.members) > max(int(keep), 1):
            old = self.members.pop(0)
            try:
                unlink(old.path)
            except OSError:
                pass

    # -- the newest-good-member walk ---------------------------------------
    def walk_newest(self, load: Callable[[Member], object],
                    on_bad: Callable[[BaseException, Member], None]):
        """Try `load(member)` newest-first.  A member whose load raises
        is reported through `on_bad(exc, member)` and dropped from the
        lineage (corrupt/truncated/mismatched snapshots never get a
        second chance); the first member that loads stays the newest and
        its load result is returned.  Returns None when no member
        survives — the caller falls back to its initial state."""
        while self.members:
            m = self.members[-1]
            try:
                return load(m)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                on_bad(e, m)
                self.members.pop()
        return None
