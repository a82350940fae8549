"""Divergence-aware lane compaction: lanes regrouped by pc at launch
boundaries.

A copy of `wasmedge_tpu/batch/compact.py` without the mesh (a
permutation here never crosses devices: `shard_slices` is always None).
Lanes that sit at different pcs share warps in admission order: a warp
whose 32 lanes run several paths pays for each of them, and a dead lane
keeps its place in the launch.  At a launch boundary the compactor:

  1. counts the boundary against the anti-thrash quantum
     (`compact_min_interval`); only a boundary that passes it reads the
     state's pc and trap planes back, in one [2, lanes] copy;
  2. estimates divergence: adjacent lane pairs whose (live, pc) keys
     differ against the least a sort can reach (distinct keys - 1), and
     the live-lane count;
  3. decides by a deterministic cost model (`compact_decision`);
  4. fires one gather over every lane plane of the state (`permute_state`:
     each plane whose last axis is the lanes, gathered into a new tensor
     on the engine's device): live lanes sort to a contiguous prefix
     keyed by (function, descending divergence score, pc, position),
     dead lanes sink to the tail in their order;
  5. in a fixed-cohort run, narrows the launch width to the smallest
     power of two (at least `compact_width_floor`) covering the live
     prefix: the kernel is launched over that many lanes (`run_chunk`'s
     `width`), the planes keep their pitch, and the lanes beyond it are
     dead and never touched.

The permutation is tracked as `src` (physical position -> original lane):
a cohort's results are gathered back to the original order through
`restore_order()` (`restore_mirrors`), a checkpoint journals it as
`lane_src` (batch/checkpoint.py), and the serving layer instead remaps its
lane -> request bindings through each permutation (serve/server.py
`_compact_round`).  B3's per-warp state (`WarpState`) is a heuristic of
each warp's interval, not lane state: it stays with the warp while its
lanes move.

Scoping: results are bit-identical with compaction on and off for guests
whose output does not depend on their lane index.  Tier-0 `random_get`
seeds its stream by the physical lane, so a random-drawing guest's bytes
follow where the permutation puts it, as at any other lane position; the
tier-0 stdout buffer (`so_buf`, `so_off`) moves with its lane, and the
host drains it in physical lane order.  `Configure.batch.compact` off (the
default) runs the uncompacted path: nothing is read back, permuted or
narrowed.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from wasmedge_tpu_torch.batch.image import TRAP_HOSTCALL


class CompactDecision(NamedTuple):
    """Deterministic boundary decision (a pure function of the mirrors
    and the knobs)."""

    fire: bool
    reason: str            # "fire" | "idle" | "interval" | "cost"
    nlive: int
    breaks: int            # adjacent key mismatches in current order
    ideal_breaks: int      # minimum achievable after a sort
    unique_pcs: int        # distinct live pcs
    largest_group: float   # largest convergent group / live lanes
    narrow_width: int      # launch width after this boundary


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def live_mask(trap: np.ndarray) -> np.ndarray:
    """Lanes that can still execute: running, or parked at a host-call
    stub (TRAP_HOSTCALL lanes re-arm and must stay in the live prefix).
    Finished and trapped lanes never resume in a cohort run."""
    trap = np.asarray(trap)
    return (trap == 0) | (trap == TRAP_HOSTCALL)


def divergence_key(img) -> Optional[np.ndarray]:
    """Per-pc divergence score from the analyzer's per-block scores
    (block pc ranges -> block_divergence), the sort's bias: lanes in
    high-divergence neighbourhoods group first.  None when the image has
    no analysis (a concatenated image, an analyzer failure): the sort
    keys on (function, pc) alone.  Never raises: compaction is a
    performance pass, not a correctness gate."""
    try:
        analysis = getattr(img, "analysis", None)
        if analysis is None:
            return None
        out = np.zeros(int(img.code_len), np.int32)
        for f in analysis.funcs:
            for bi, b in enumerate(f.cfg.blocks):
                lo = max(int(b.start), 0)
                hi = min(int(b.end), out.size - 1)
                if hi >= lo:
                    out[lo:hi + 1] = int(f.block_divergence[bi])
        return out
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        return None


def function_key(img) -> Optional[np.ndarray]:
    """Per-pc engine-global function ordinal from the image's entry pcs,
    the sort's first live key: on a concatenated image `f_entry` is
    rebased per tenant, so serving mixes regroup by function (and
    tenant) before the finer keys order lanes inside one body.  Needs no
    analysis.  Never raises."""
    try:
        entries = np.asarray(getattr(img, "f_entry"), np.int64)
        entries = np.sort(entries[entries >= 0])
        if entries.size == 0:
            return None
        pcs = np.arange(int(img.code_len), dtype=np.int64)
        return np.searchsorted(entries, pcs, side="right").astype(
            np.int64) - 1
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        return None


def estimate_breaks(pc: np.ndarray, live: np.ndarray,
                    shard_slices: Optional[List[slice]] = None):
    """(breaks, ideal_breaks, unique_pcs, largest_group_fraction) of the
    current lane order: `breaks` counts adjacent lane pairs whose (live,
    pc) keys differ (dead lanes share one key), `ideal` is the least a
    perfect sort leaves.  With `shard_slices` both are per slice and
    summed (the JAX mesh's rule; the port passes None)."""
    key = np.where(live, np.asarray(pc, np.int64), np.int64(-1))
    nlive = int(live.sum())
    breaks = ideal = 0
    for sl in (shard_slices or [slice(0, key.size)]):
        ks, ls = key[sl], live[sl]
        breaks += int(np.count_nonzero(ks[1:] != ks[:-1]))
        ns = int(ls.sum())
        if ns:
            ideal += int(np.unique(ks[ls]).size) - 1 \
                + (1 if ns < ls.size else 0)
    if nlive == 0:
        return breaks, 0, 0, 1.0
    _, counts = np.unique(key[live], return_counts=True)
    return breaks, ideal, int(counts.size), float(counts.max()) / nlive


def build_permutation(pc: np.ndarray, trap: np.ndarray,
                      dscore: Optional[np.ndarray] = None,
                      shard_slices: Optional[List[slice]] = None,
                      fnkey: Optional[np.ndarray] = None) -> np.ndarray:
    """The boundary permutation as `perm` (destination -> source lane):
    new_plane[..., d] = old_plane[..., perm[d]].  Live lanes sort to the
    front keyed by (function ordinal, descending divergence score, pc,
    original position), dead lanes keep their order at the tail.  A
    bijection, and stable: an already grouped population is a no-op."""
    pc = np.asarray(pc, np.int64)
    live = live_mask(trap)
    n = pc.size
    if dscore is not None and dscore.size:
        score = np.asarray(dscore, np.int64)[np.clip(pc, 0,
                                                     dscore.size - 1)]
    else:
        score = np.zeros(n, np.int64)
    if fnkey is not None and fnkey.size:
        fk = np.asarray(fnkey, np.int64)[np.clip(pc, 0, fnkey.size - 1)]
    else:
        fk = np.zeros(n, np.int64)
    dead = (~live).astype(np.int64)
    pckey = np.where(live, pc, np.int64(0))
    skey = np.where(live, -score, np.int64(0))
    fkey = np.where(live, fk, np.int64(0))
    pos = np.arange(n, dtype=np.int64)
    perm = np.empty(n, np.int64)
    for sl in (shard_slices or [slice(0, n)]):
        # np.lexsort: the LAST key is primary -> (dead, fn, -score, pc, pos)
        order = np.lexsort((pos[sl], pckey[sl], skey[sl], fkey[sl],
                            dead[sl]))
        perm[sl] = order + sl.start
    return perm


def compact_decision(pc: np.ndarray, trap: np.ndarray, width: int,
                     steps_per_launch: int, rounds_since_fire: int,
                     knobs, can_narrow: bool,
                     shard_slices: Optional[List[slice]] = None
                     ) -> CompactDecision:
    """When to fire: the cost model, the trigger and the anti-thrash
    quantum.  `width` is the current launch width; a permutation's copy
    is modelled as `compact_cost_factor` lane-steps a lane, the win as
    one saved break per step (sorting) plus the narrowed slice
    (packing)."""
    interval = max(int(getattr(knobs, "compact_min_interval", 2)), 1)
    trigger = float(getattr(knobs, "compact_trigger", 0.05))
    cost_factor = float(getattr(knobs, "compact_cost_factor", 4.0))
    floor = max(int(getattr(knobs, "compact_width_floor", 64)), 1)
    lanes = int(np.asarray(trap).size)
    live = live_mask(trap)
    breaks, ideal, unique, largest = estimate_breaks(pc, live,
                                                     shard_slices)
    nlive = int(live.sum())
    narrow_w = int(width)
    if can_narrow and nlive > 0:
        target = min(max(next_pow2(nlive), floor), int(width))
        if target < width:
            narrow_w = target
    if nlive == 0:
        return CompactDecision(False, "idle", 0, breaks, ideal, unique,
                               largest, int(width))
    if rounds_since_fire < interval:
        return CompactDecision(False, "interval", nlive, breaks, ideal,
                               unique, largest, int(width))
    win = max(breaks - ideal, 0)
    sort_pays = (win >= 1 and win >= trigger * nlive
                 and win * max(int(steps_per_launch), 1)
                 >= cost_factor * lanes)
    if not sort_pays and narrow_w >= width:
        return CompactDecision(False, "cost", nlive, breaks, ideal,
                               unique, largest, int(width))
    return CompactDecision(True, "fire", nlive, breaks, ideal, unique,
                           largest, narrow_w)


def lane_plane_names(state, lanes: int) -> Tuple[str, ...]:
    """The state's planes that carry a lane column (last axis == lanes):
    the rule of `wasmedge_tpu/hv/swapstore.py:242-256`."""
    out = []
    for name in state.FIELDS:
        plane = getattr(state, name)
        if plane is None:
            continue
        if plane.ndim == 0 or plane.shape[-1] != lanes:
            continue
        out.append(name)
    return tuple(out)


class LaneCompactor:
    """Per-run (a cohort's) or per-server compaction state: the composed
    permutation (`src`), the current launch width, the counts.

    The cohort drivers (`BatchEngine.run`, `MultiTenantBatchEngine.
    run_tenants`) arm one on the engine (`engine.compactor`) and
    `run_slice` calls `boundary()` before each launch; the serving layer
    holds its own (narrowing off) and remaps its binding tables through
    each permutation (serve/server.py `_compact_round`).  `host_s` is the
    host seconds of the boundaries past the quantum (read-back, decision
    and permutation built), `permute_ms` the gathers' time, `widths` the
    width of each launch."""

    def __init__(self, engine, narrow: Optional[bool] = None):
        self.engine = engine
        self.cfg = engine.cfg
        self.lanes = int(engine.lanes)
        allow = bool(self.cfg.compact_narrow)
        self.narrow = allow if narrow is None else bool(narrow) and allow
        self.src = np.arange(self.lanes, dtype=np.int64)
        self.width = self.lanes
        self.rounds = 0
        self.last_fire = -(1 << 30)
        self._dscore = None
        self._dscore_ready = False
        self._fnkey = None
        self._fnkey_ready = False
        self.widths: List[int] = []   # the width of each launch
        self.host_s = 0.0
        self.permute_ms = 0.0
        self.stats = {"fires": 0, "noop_fires": 0, "rounds": 0,
                      "skipped_interval": 0, "skipped_cost": 0,
                      "moved_lanes": 0, "dispatch_slots": 0,
                      "min_width": self.lanes}

    def dscore(self, img) -> Optional[np.ndarray]:
        if not self._dscore_ready:
            self._dscore = divergence_key(img)
            self._dscore_ready = True
        return self._dscore

    def fnkey(self, img) -> Optional[np.ndarray]:
        if not self._fnkey_ready:
            self._fnkey = function_key(img)
            self._fnkey_ready = True
        return self._fnkey

    # -- permutation bookkeeping -------------------------------------------
    @property
    def identity(self) -> bool:
        return bool((self.src == np.arange(self.lanes)).all())

    def restore_order(self) -> Optional[np.ndarray]:
        """For each original lane, the physical position holding it (the
        argsort of src); None when no permutation ever fired."""
        if self.identity:
            return None
        return np.argsort(self.src, kind="stable")

    def tick(self) -> bool:
        """One boundary: False while the anti-thrash quantum holds
        (nothing is read back or computed then)."""
        self.rounds += 1
        self.stats["rounds"] += 1
        if self.rounds - self.last_fire < max(self.cfg.compact_min_interval,
                                              1):
            self.stats["skipped_interval"] += 1
            return False
        return True

    def decide(self, pc, trap) -> CompactDecision:
        d = compact_decision(
            pc, trap, self.width, int(self.cfg.steps_per_launch),
            self.rounds - self.last_fire, self.cfg, self.narrow, None)
        if not d.fire and d.reason == "cost":
            self.stats["skipped_cost"] += 1
        return d

    def plan_boundary(self, engine, state):
        """tick -> read back -> decide -> build, shared by the cohort
        `boundary()` and the server's `_compact_round`: (decision, perm)
        when a permutation other than the identity should be applied,
        else None.  An identity fire still resets the quantum and
        applies narrowing (`fired(moved=False)`) but is not counted as a
        compaction.  The host seconds past the quantum go to host_s."""
        if not self.tick():
            return None
        t0 = time.perf_counter()
        mirrors = torch.stack([state.pc, state.trap]).cpu().numpy()
        pc, trap = mirrors[0], mirrors[1]
        d = self.decide(pc, trap)
        plan = None
        if d.fire:
            perm = build_permutation(pc, trap, self.dscore(engine.img),
                                     None, fnkey=self.fnkey(engine.img))
            if (perm == np.arange(perm.size)).all():
                self.fired(d, moved=False)
            else:
                plan = d, perm
        self.host_s += time.perf_counter() - t0
        return plan

    def fired(self, d: CompactDecision, moved: bool = True):
        """A fire's side effects: narrowing and the quantum always; the
        fire count only when lanes moved (`moved=False`: the identity
        permutation, e.g. a narrowing-only boundary on sorted lanes)."""
        if d.narrow_width < self.width:
            self.width = d.narrow_width
            self.stats["min_width"] = min(self.stats["min_width"],
                                          self.width)
        self.last_fire = self.rounds
        self.stats["fires" if moved else "noop_fires"] += 1

    def permute_state(self, state, perm: np.ndarray):
        """Apply one boundary permutation: one gather along the lane axis
        of every lane plane into a new int32 contiguous tensor on the
        plane's device (for a moment each plane is held twice), the
        engine's exactly-once stdout cursor (`batch/hostcall.py`
        `_stdout_cursor`, host arrays) and the composed src mapping.  The
        state object is updated and returned; the gathers' time goes to
        permute_ms (CUDA events on the card)."""
        dev = state.pc.device
        idx = torch.as_tensor(perm, dtype=torch.int64, device=dev)
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        else:
            t0 = time.perf_counter()
        for name in lane_plane_names(state, self.lanes):
            plane = getattr(state, name)
            setattr(state, name, plane.index_select(plane.ndim - 1, idx))
        if dev.type == "cuda":
            ev[1].record()
            ev[1].synchronize()
            self.permute_ms += ev[0].elapsed_time(ev[1])
        else:
            self.permute_ms += (time.perf_counter() - t0) * 1e3
        self.src = self.src[perm]
        cur = getattr(self.engine, "_stdout_cursor", None)
        if cur is not None and cur[0].size == self.lanes:
            cur[0][:] = cur[0][perm]
            cur[1][:] = cur[1][perm]
        self.stats["moved_lanes"] += int((perm
                                          != np.arange(perm.size)).sum())
        return state

    # -- the engine's boundary ---------------------------------------------
    def boundary(self, engine, state):
        """Before a launch of a fixed-cohort run: decide, permute and
        narrow.  The quantum check runs before any read-back: a boundary
        off the quantum costs a counter."""
        plan = self.plan_boundary(engine, state)
        if plan is not None:
            d, perm = plan
            state = self.permute_state(state, perm)
            self.fired(d)
        return state

    def note_launch(self, steps: int):
        """Dispatch-slot accounting: one slot per (step, lane) of the
        current width; the steps are the JAX loop's (the launch's
        largest retired delta)."""
        self.stats["dispatch_slots"] += int(steps) * self.width
        self.widths.append(self.width)


def restore_mirrors(comp, stack_lo, stack_hi, trap, retired):
    """Gather a cohort's result mirrors (numpy) back to the original lane
    order through the compactor's composed permutation; unchanged with
    no compactor or the identity."""
    order = None if comp is None else comp.restore_order()
    if order is None:
        return stack_lo, stack_hi, trap, retired
    return (stack_lo[:, order], stack_hi[:, order],
            trap[order], retired[order])


def arm(engine) -> Optional[LaneCompactor]:
    """A fresh compactor for a cohort run (None when the knob is off or
    the engine's compaction is managed outside it, as a serving engine's
    is)."""
    if getattr(engine.cfg, "compact", False) \
            and not getattr(engine, "_compact_external", False):
        engine.compactor = LaneCompactor(engine)
    else:
        engine.compactor = None
    return engine.compactor


def restore_lane_src(engine, src: Optional[np.ndarray]):
    """The checkpoint restore's half of the src tracking: `src` is the
    journaled lane_src (None when the snapshot predates any compaction).
    Rolls the engine's compactor back to the snapshot's mapping, and
    refuses a permuted snapshot when compaction is unavailable (results
    would come back lane-shuffled)."""
    lanes = int(engine.lanes)
    identity = src is None or bool(
        (np.asarray(src) == np.arange(lanes)).all())
    managed = getattr(engine, "_compact_external", False)
    comp = getattr(engine, "compactor", None)
    if identity:
        if comp is not None:
            comp.src = np.arange(lanes, dtype=np.int64)
            comp.width = lanes
        return
    if managed or not getattr(engine.cfg, "compact", False):
        raise ValueError(
            "checkpoint refused: snapshot carries a lane compaction "
            "permutation (lane_src) but this engine cannot restore it "
            + ("(compaction is managed outside this engine)" if managed
               else "(Configure.batch.compact is off)"))
    if comp is None:
        comp = engine.compactor = LaneCompactor(engine)
    comp.src = np.asarray(src, np.int64).copy()
    comp.width = lanes   # restart at full width; narrowing fires again
