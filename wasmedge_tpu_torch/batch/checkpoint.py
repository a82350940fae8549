"""Checkpoint and resume of a batch's execution state.

A copy of `wasmedge_tpu/batch/checkpoint.py` over the port's
`BatchState`: every plane of the state is a lane-fastest int32 array, so
snapshotting thousands of in-flight instances is a plain array save.  A
checkpoint is an .npz of every plane (`state_<name>`) plus a metadata
record (`meta`, JSON) that binds it to the module image (a content hash)
and the engine's geometry, and to the execution cursor (retired steps),
so that a resume onto a different image or a tampered file is refused,
not misexecuted; beside it a `.sha256` sidecar holds the file's digest.
The format is the JAX package's.

Flow: `state = engine.initial_state(...)`; drive it in slices with
`engine.run_from_state(state, total, budget)`; `save(path, engine,
state, total)` at any boundary; later `state, total = load(path,
engine)` (the planes on the engine's device) and keep driving.  Works
for single-module and multi-tenant engines alike (the state layout is
the same).

Lane compaction (batch/compact.py): when the engine's compactor has
moved lanes, the mapping is saved as `lane_src`, and `load` rolls the
engine's compactor back to it (`restore_lane_src`); an engine with
compaction off, or managed outside it (a serving engine), refuses such a
snapshot.  With a tier-0 stdout buffer, each lane's logical stdout
position (`batch/hostcall.py` `_stdout_cursor`) is saved as
`stdout_pos`, and `load` rewinds the engine's position to it while the
engine's written high-water mark only grows, so records flushed after
the snapshot are not printed again (exactly once in one process).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Tuple

import numpy as np

from wasmedge_tpu_torch.batch.compact import restore_lane_src
from wasmedge_tpu_torch.batch.engine import (
    SIMD_FIELDS, T0_FIELDS, BatchState, a3_plane_rows)
from wasmedge_tpu_torch.batch.hostcall import _stdout_cursor
from wasmedge_tpu_torch.batch.image import (
    CLS_HOSTCALL, T0_FD_WRITE, TRAP_HOSTCALL)
from wasmedge_tpu_torch.utils.fsio import atomic_write_bytes

FORMAT_VERSION = 1


def image_fingerprint(img) -> str:
    """Content hash over the device image's executable planes."""
    h = hashlib.sha256()
    for name in ("cls", "sub", "a", "b", "c", "imm_lo", "imm_hi",
                 "br_table", "f_entry", "f_nparams", "f_nlocals",
                 "f_nresults", "f_frame_top", "f_type", "table0"):
        h.update(np.ascontiguousarray(getattr(img, name)).tobytes())
    if img.v128 is not None:
        # v128 constants and shuffle masks are executable content too
        h.update(np.ascontiguousarray(img.v128).tobytes())
    # the segment snapshots feed table.init / memory.init
    for name in ("elem_flat", "elem_off", "elem_len",
                 "data_words", "data_off", "data_len"):
        arr = getattr(img, name, None)
        if arr is not None:
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _geometry(engine) -> dict:
    cfg = engine.cfg
    return {"value_stack_depth": cfg.value_stack_depth,
            "call_stack_depth": cfg.call_stack_depth,
            "memory_pages_per_lane": cfg.memory_pages_per_lane,
            "mem_pages_max": int(engine.img.mem_pages_max)}


def save(path, engine, state: BatchState, total_steps: int,
         invocation=None, stdout_pos=None, extra_arrays=None):
    """Snapshot an in-flight batch to `path` (.npz; or a writable file
    object, then without the sidecar).

    `invocation` (optional dict, e.g. the function name and an argument
    fingerprint) is recorded in the metadata, so that a resume in
    another process can refuse a snapshot taken for a different call:
    the image hash alone cannot tell f(30) from f(31).  `extra_arrays`
    ({name: ndarray}) ride beside the planes; names must not collide
    with the `state_` prefix; `load` ignores them, `read_extra_arrays`
    reads them back.  `stdout_pos` (each lane's logical stdout
    position; None: the engine's cursor) is saved when the state has a
    tier-0 stdout buffer."""
    meta = {
        "format": FORMAT_VERSION,
        "image_sha256": image_fingerprint(engine.img),
        "lanes": engine.lanes,
        "total_steps": int(total_steps),
        # trap thresholds and plane shapes depend on the geometry: a
        # resume under other knobs would misexecute, so bind them
        "geometry": _geometry(engine),
    }
    if invocation is not None:
        meta["invocation"] = invocation
    arrays = {f"state_{name}": plane
              for name, plane in state.to_numpy().items()
              if plane is not None}
    # the stdout cursor's logical positions rewind with the state on
    # restore; saved (zeros) before the first flush too, or the first
    # flush after a restore to such a snapshot would not be suppressed
    if state.so_buf is not None:
        if stdout_pos is None:
            stdout_pos = _stdout_cursor(engine, int(state.so_off.shape[0]))[0]
        arrays["stdout_pos"] = np.asarray(stdout_pos, np.int64)
    # the lane compaction mapping rolls back with the state on restore,
    # or results would come back lane-shuffled
    comp = getattr(engine, "compactor", None)
    if comp is not None and not comp.identity:
        arrays["lane_src"] = np.asarray(comp.src, np.int64)
    for name, arr in (extra_arrays or {}).items():
        if name.startswith("state_") or name in arrays:
            raise ValueError(f"extra array name {name!r} collides with "
                             f"a state plane")
        arrays[name] = np.asarray(arr)
    buf = io.BytesIO()
    np.savez_compressed(buf, meta=json.dumps(meta), **arrays)
    data = buf.getvalue()
    if hasattr(path, "write"):
        path.write(data)
        return
    # an interrupted save never leaves a truncated file at the target,
    # nor clobbers an earlier good snapshot
    atomic_write_bytes(path, data)
    # the digest sidecar (best-effort: the archive's own checks back a
    # missing one)
    try:
        atomic_write_bytes(os.fspath(path) + ".sha256",
                           hashlib.sha256(data).hexdigest().encode())
    except OSError:
        pass


def read_meta(path) -> dict:
    """The metadata record alone (no state is rebuilt)."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["meta"]))


def read_extra_arrays(path, prefix: str) -> dict:
    """The extra (non-state) arrays whose names start with `prefix`."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for name in z.files:
            if name.startswith(prefix):
                out[name] = np.asarray(z[name])
    return out


def load(path, engine) -> Tuple[BatchState, int]:
    """Restore a snapshot onto `engine`'s device: (state, total steps).
    Refuses a checkpoint of another image or geometry, one that lacks
    planes the engine needs, one whose control planes leave the image,
    and a permuted one the engine cannot restore."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("format") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint format {meta.get('format')}")
        if meta["image_sha256"] != image_fingerprint(engine.img):
            raise ValueError("checkpoint was taken from a different module "
                             "image")
        if meta["lanes"] != engine.lanes:
            raise ValueError(f"checkpoint has {meta['lanes']} lanes, "
                             f"engine has {engine.lanes}")
        want_geom = _geometry(engine)
        if meta.get("geometry") != want_geom:
            raise ValueError(
                f"checkpoint geometry {meta.get('geometry')} does not "
                f"match the engine's {want_geom}")
        fields = {}
        for name in BatchState.FIELDS:
            key = f"state_{name}"
            fields[name] = np.asarray(z[key]) if key in z.files else None
        if engine.img.has_simd:
            missing = [n for n in SIMD_FIELDS if fields.get(n) is None]
            if missing:
                raise ValueError(
                    "checkpoint refused: geometry mismatch: the engine's "
                    f"image has v128 but the checkpoint lacks planes "
                    f"{missing}")
        missing = [n for n in a3_plane_rows(engine.img)
                   if fields.get(n) is None]
        if missing:
            raise ValueError(
                "checkpoint refused: the engine's image uses tables or "
                f"segments but the checkpoint lacks planes {missing}")
        t0kinds = getattr(engine, "t0kinds", None)
        if t0kinds is not None:
            want = [T0_FIELDS[0]]
            if (t0kinds == T0_FD_WRITE).any():
                want += list(T0_FIELDS[1:])
            missing = [n for n in want if fields.get(n) is None]
            if missing:
                raise ValueError(
                    "checkpoint refused: the engine serves tier-0 host "
                    f"calls but the checkpoint lacks planes {missing}")
        _validate_planes(fields, engine)
        src = np.asarray(z["lane_src"], np.int64) \
            if "lane_src" in z.files else None
        # the journaled position replaces the engine's; the written mark
        # only grows (output flushed after this snapshot stays suppressed
        # in this process)
        if "stdout_pos" in z.files:
            journaled = np.asarray(z["stdout_pos"], np.int64)
            pos, hw = _stdout_cursor(engine, journaled.size)
            pos[:] = journaled
            hw[:] = _marks_at(engine, hw, src)
            np.maximum(hw, journaled, out=hw)
        restore_lane_src(engine, src)
    return BatchState.from_numpy(fields, engine.device), meta["total_steps"]


def _marks_at(engine, hw, src):
    """The engine's written marks `hw` (in its lanes' present order)
    moved to the snapshot's lane order `src` (None: identity): a lane
    that the compactor moved after the snapshot takes its mark back
    with it.  The JAX package's `load` leaves the marks in place, so
    there a lane that moved after the snapshot is held to another lane's
    mark (ROADMAP C12)."""
    comp = getattr(engine, "compactor", None)
    now = None if comp is None or comp.src.size != hw.size else comp.src
    if now is None and src is None:
        return hw
    ident = np.arange(hw.size)
    by_lane = np.empty_like(hw)
    by_lane[ident if now is None else now] = hw
    return by_lane[ident if src is None else src]


def _validate_planes(fields, engine):
    """Refuse control planes a crafted file could use to misexecute.

    The image hash and geometry prove where the code came from; this
    proves that the restored control state stays inside it: the host's
    serve rounds index frames with fp and the operand base, so negative
    or oversized values would reach other frames' rows instead of
    trapping."""
    cfg = engine.cfg
    img = engine.img
    D = cfg.value_stack_depth
    CD = cfg.call_stack_depth
    pc = np.asarray(fields["pc"])
    sp = np.asarray(fields["sp"])
    fp = np.asarray(fields["fp"])
    ob = np.asarray(fields["opbase"])
    cd = np.asarray(fields["call_depth"])
    pages = np.asarray(fields["mem_pages"])
    trap = np.asarray(fields["trap"])
    # the TRAP_HOSTCALL sentinel re-enters host serving on resume: it is
    # legitimate only when the lane really sits at a host-call stub
    at_stub = img.cls[np.clip(pc, 0, img.code_len - 1)] == CLS_HOSTCALL
    # a lane that stopped never runs from these pointers again (a
    # server's install writes them anew): once its entry function has
    # returned, sp sits at its results, below the operand base, so only
    # their bounds are held there (the JAX package holds the order on
    # every lane and refuses such a snapshot: ROADMAP C14)
    runs = (trap == 0) | (trap == TRAP_HOSTCALL)
    in_bounds = (fp >= 0) & (ob >= 0) & (sp >= 0) & (ob <= D) & (sp <= D)
    checks = [
        ("pc", (pc >= 0) & (pc < img.code_len)),
        ("stack pointers", in_bounds
         & (~runs | ((fp <= ob) & (ob <= sp)))),
        ("call_depth", (cd >= 0) & (cd <= CD)),
        ("mem_pages", (pages >= 0) & (pages <= max(img.mem_pages_max, 0))),
        ("trap", (trap >= TRAP_HOSTCALL) & (trap < 256)
         & ((trap != TRAP_HOSTCALL) | at_stub)),
    ]
    # live call frames (rows below call_depth) feed a return's pc, fp and
    # operand base verbatim
    live = np.arange(CD)[:, None] < cd[None, :]
    fr_pc = np.asarray(fields["fr_ret_pc"])
    fr_fp = np.asarray(fields["fr_fp"])
    fr_ob = np.asarray(fields["fr_opbase"])
    checks += [
        ("frame ret_pc", ~live | ((fr_pc >= 0) & (fr_pc < img.code_len))),
        ("frame fp/opbase", ~live | ((fr_fp >= 0) & (fr_fp <= fr_ob)
                                     & (fr_ob <= D))),
    ]
    for name, ok in checks:
        if not bool(np.all(ok)):
            lane = int(np.argmin(np.all(ok, axis=0) if ok.ndim == 2 else ok))
            raise ValueError(
                f"checkpoint refused: {name} plane out of range "
                f"(first bad lane {lane})")
