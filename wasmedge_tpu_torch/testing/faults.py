"""Deterministic fault injection for supervised batch execution.

A copy of the seams of `wasmedge_tpu/testing/faults.py` that the port
has.  The supervisor (batch/supervisor.py) and the server
(serve/server.py) arm a `FaultInjector` on the engine's seams:
`"launch"` before every kernel launch and `"serve"` before every
in-loop tier-1 serve round (both fired through `BatchEngine._fault_hook`
inside `run_slice`), and `"checkpoint_save"` / `"checkpoint_load"`
around the snapshot lineage.  A `FaultInjector` counts arrivals at each
seam and raises an `InjectedFault` at the configured occurrence
indices, so a test can reproduce "the 3rd launch dies", "the first WASI
serve raises" or "the newest checkpoint is corrupt" bit for bit every
run.

Fault classes the tests drive:
  - launch-time device error       Fault(point="launch", ...)
  - mid-serve host exception       Fault(point="serve", ...)
  - corrupt or truncated checkpoint corrupt_checkpoint(path, ...) through
                                   Fault.before, or a "checkpoint_load"
                                   fault
  - runaway or poison lane         build_selective_runaway() +
                                   SupervisorConfigure.lane_step_cap, or
                                   a lane-attributed Fault(lanes=(k,))

Not here yet: the bit-flip seams (`BitFlip`, `FaultInjector.flip`,
`bitflip_campaign`) come with the integrity audit, the gateway's chaos
schedule with the gateway, and the partition and churn schedules with
more than one card.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional, Sequence, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """The exception a Fault raises; carries the seam name and an
    optional lane attribution the supervisor's poison quarantine
    consumes (real device errors carry no attribution: whole-batch retry
    is the fallback)."""

    def __init__(self, point: str, index: int, lanes: Tuple[int, ...] = (),
                 message: str = ""):
        super().__init__(
            message or f"injected fault at {point}[{index}]"
            + (f" lanes={list(lanes)}" if lanes else ""))
        self.point = point
        self.index = index
        self.lanes = tuple(int(x) for x in lanes)


@dataclasses.dataclass
class Fault:
    """One armed fault: fire on arrivals [at, at + times) at `point`."""

    point: str                 # "launch" | "serve" | "checkpoint_save" |
    #                            "checkpoint_load"
    at: int = 0                # 0-based arrival index at that seam
    times: int = 1             # consecutive arrivals that fault
    lanes: Tuple[int, ...] = ()  # lane attribution (poison quarantine)
    message: str = ""
    # runs just before raising, e.g. to corrupt the newest checkpoint file
    # so that the restore walks the lineage back
    before: Optional[Callable[..., None]] = None
    # custom exception factory (ctx dict -> exception); default
    # InjectedFault
    exc: Optional[Callable[..., BaseException]] = None
    # context filter: only arrivals whose fire() ctx is a superset of
    # this dict are considered, and `at` then indexes the MATCHED
    # arrivals (a per-fault counter) instead of all arrivals at the seam
    match: Optional[dict] = None


def flip_bit_bytes(data: bytes, seed: int = 0,
                   bit: Optional[int] = None) -> bytes:
    """Return `data` with one seeded bit flipped."""
    buf = bytearray(data)
    if not buf:
        return bytes(buf)
    rng = np.random.RandomState(int(seed) & 0x7FFFFFFF)
    pos = int(rng.randint(len(buf)))
    b = int(bit) if bit is not None else int(rng.randint(8))
    buf[pos] ^= 1 << b
    return bytes(buf)


def flip_file(path, seed: int = 0, bit: Optional[int] = None):
    """Flip one seeded bit of a file in place (at-rest rot of a
    checkpoint).  Deliberately not atomic: rot does not fsync."""
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(flip_bit_bytes(data, seed=seed, bit=bit))


class FaultInjector:
    """Deterministic seam counter: `fire(point, **ctx)` raises when an
    armed fault covers this arrival.  `counts` holds the arrivals at each
    seam and `log` every raised fault as (point, index).  Thread-safe: a
    server's checkpoint() may fire from another thread than its serving
    loop."""

    def __init__(self, faults: Sequence[Fault]):
        self.faults = list(faults)
        self.counts = {}
        self.log = []
        self._match_counts = {}
        self._lock = threading.Lock()

    def fire(self, point: str, **ctx):
        with self._lock:
            i = self.counts.get(point, 0)
            self.counts[point] = i + 1
            fire_f = fire_idx = None
            for fi, f in enumerate(self.faults):
                if f.point != point:
                    continue
                if f.match is not None:
                    if any(ctx.get(k) != v for k, v in f.match.items()):
                        continue
                    j = self._match_counts.get(fi, 0)
                    self._match_counts[fi] = j + 1
                    idx = j
                else:
                    idx = i
                if not (f.at <= idx < f.at + f.times):
                    continue
                if fire_f is None:
                    fire_f, fire_idx = f, idx
            if fire_f is None:
                return
            f, idx = fire_f, fire_idx
            if f.before is not None:
                f.before()
            self.log.append((point, idx))
        if f.exc is not None:
            raise f.exc(dict(ctx, point=point, index=idx))
        raise InjectedFault(point, idx, lanes=f.lanes,
                            message=f.message)

    @property
    def fired(self) -> int:
        return len(self.log)


def seeded_faults(seed: int, points: Sequence[str] = ("launch", "serve"),
                  n: int = 1, max_at: int = 4) -> list:
    """Derive `n` faults deterministically from a seed (the fuzz mode of
    the harness: same seed, same incident schedule)."""
    rng = np.random.RandomState(int(seed) & 0x7FFFFFFF)
    out = []
    for _ in range(n):
        out.append(Fault(point=points[int(rng.randint(len(points)))],
                         at=int(rng.randint(max_at + 1))))
    return out


def corrupt_checkpoint(path, mode: str = "truncate", seed: int = 0):
    """Damage a checkpoint file in place (the "corrupt or truncated
    checkpoint" fault class).  `truncate` cuts the file mid-archive (an
    interrupted writer that was not atomic); `flip` xor-scrambles a span
    of 64 bytes (bit rot, a torn write).  checkpoint.load must refuse
    both cleanly."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if mode == "truncate":
        data = data[:max(len(data) // 2, 1)]
    elif mode == "flip":
        rng = np.random.RandomState(seed)
        pos = int(rng.randint(max(len(data) - 64, 1)))
        for k in range(min(64, len(data) - pos)):
            data[pos + k] ^= 0xA5
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "wb") as f:
        f.write(bytes(data))


def build_selective_runaway() -> bytes:
    """Module whose export `work(n)` loops forever for n < 0 and returns
    sum(0..n) otherwise: one poisoned argument turns one lane into a
    runaway while its neighbours finish.  Drives the supervisor's
    lane_step_cap quarantine."""
    from wasmedge_tpu_torch.utils.builder import ModuleBuilder

    b = ModuleBuilder()
    b.add_function(["i32"], ["i32"], ["i32", "i32"], [
        ("local.get", 0), ("i32.const", 0), "i32.lt_s",
        ("if", None),
        ("loop", None), ("br", 0), "end",
        "end",
        ("block", None),
        ("loop", None),
        ("local.get", 1), ("local.get", 0), "i32.ge_u", ("br_if", 1),
        ("local.get", 2), ("local.get", 1), "i32.add", ("local.set", 2),
        ("local.get", 1), ("i32.const", 1), "i32.add", ("local.set", 1),
        ("br", 0),
        "end",
        "end",
        ("local.get", 2),
    ], export="work")
    return b.build()
