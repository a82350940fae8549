"""Pre-initialized lane snapshots: run a module's init once, admit its
requests from the captured columns.

A copy of `wasmedge_tpu/imagestore/snapshot.py`.  At registration the
gateway runs the module's nullary `_initialize` (reactor) or `_start`
(command) export once on the module's one-lane engine, on the gateway's
device, captures the post-init columns of the lane (memory, globals,
table, dropped-segment flags) and stores them as a content-addressed
SwapStore payload.  A generation build decodes the entry into an
`init_overlay` of `MultiModuleBatchEngine`, whose `initial_state` then
starts every admitted lane of the module from the post-init state
instead of the template (batch/multitenant.py).

Capture is best-effort about the guest: no init export, an init that
traps, runs out of steps or parks at a host call (its effects would reach
the WASI environ, which an overlay cannot carry) all mean "no snapshot",
and the module admits through template init.  It is not about the
runtime: a kernel that does not build or a launch that fails is raised,
and the gateway rolls the registration back (gateway/service.py).  Install verifies the payload (SwapStore
re-hashes it; the `snapshot_install` fault seam injects a failure) and
falls back the same way: wrong state is never served.

One difference: the JAX capture cuts the memory rows at the analyzer's
proven page-touch bound (`mem_pages_touch_bound`), which the port's
analyzer does not compute, so the port keeps every row of the pages the
lane holds after init.  The overlay writes rows [0, n) only, and the rows
past a JAX capture's bound hold the template's content, so both install
the same column.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from wasmedge_tpu_torch.batch.image import TRAP_DONE
from wasmedge_tpu_torch.common.errors import WasmError

_PAGE_WORDS = 65536 // 4

# reactor-style _initialize first; a command _start that also runs main()
# is still a valid snapshot point (the captured state is post-main)
_INIT_EXPORTS = ("_initialize", "_start")


@dataclasses.dataclass
class SnapshotEntry:
    """One captured post-init state: the SwapStore key and the scalar
    side-meta the overlay needs (page count, table size)."""

    key: str
    meta: dict


def init_export_of(rm) -> Optional[str]:
    """The module's nullary init export name, or None."""
    for name in _INIT_EXPORTS:
        ex = rm.inst.exports.get(name)
        if ex is None or ex[0] != 0:
            continue
        ft = rm.inst.funcs[ex[1]].functype
        if not tuple(ft.params) and not tuple(ft.results):
            return name
    return None


def _bump(counts: dict, key: str) -> None:
    counts[key] = counts.get(key, 0) + 1


def capture_snapshot(rm, store, counts: dict,
                     max_steps: int = 2_000_000) -> Optional[SnapshotEntry]:
    """Run `rm`'s init once on its registration engine and store the
    post-init columns; returns the entry, or None (skipped).  The
    engine's image is untouched: `initial_state` makes a fresh state."""
    from wasmedge_tpu_torch.batch.engine import check_batch_entry
    from wasmedge_tpu_torch.hv.swapstore import serialize_columns

    name = init_export_of(rm)
    if name is None:
        return None
    eng = rm.engine  # the one-lane BatchEngine kept from registration
    state = eng.initial_state(check_batch_entry(rm.inst, name), [])
    try:
        state, _total = eng.run_from_state(state, 0, max_steps)
    except WasmError:
        # a host call of the init failed in the guest's terms
        _bump(counts, "skipped")
        return None
    if int(state.trap[0]) != TRAP_DONE:
        # still running, trapped, or parked on a host call: the overlay
        # cannot hold any of those, so the module admits via template init
        _bump(counts, "skipped")
        return None
    img = eng.img
    cols = {}
    meta = {"module": rm.name, "sha": rm.sha256}
    if img.has_memory:
        pages = int(state.mem_pages[0])
        meta["mem_pages"] = pages
        rows = min(pages * _PAGE_WORDS, state.mem.shape[0])
        cols["mem"] = state.mem[:rows, 0].cpu().numpy()
    cols["glob_lo"] = state.glob_lo[:, 0].cpu().numpy()
    cols["glob_hi"] = state.glob_hi[:, 0].cpu().numpy()
    if state.tab is not None:
        cols["tab"] = state.tab[:, 0].cpu().numpy()
        meta["tsize"] = int(state.tsize[0])
    if state.edrop is not None:
        cols["edrop"] = state.edrop[:, 0].cpu().numpy()
    if state.ddrop is not None:
        cols["ddrop"] = state.ddrop[:, 0].cpu().numpy()
    key = store.put(serialize_columns(cols, meta))
    _bump(counts, "captured")
    return SnapshotEntry(key=key, meta=meta)


def decode_overlay(rm, store, faults=None,
                   counts: Optional[dict] = None) -> Optional[dict]:
    """SnapshotEntry -> `init_overlays` dict for the serving engine, or
    None (template init) on any integrity or injected failure."""
    from wasmedge_tpu_torch.hv.swapstore import (
        SwapCorrupt, deserialize_columns)

    entry = getattr(rm, "snapshot", None)
    if entry is None:
        return None
    counts = counts if counts is not None else {}
    if faults is not None:
        from wasmedge_tpu_torch.testing.faults import InjectedFault

        try:
            faults.fire("snapshot_install", module=rm.name, key=entry.key)
        except InjectedFault:
            _bump(counts, "install_faults")
            return None
    try:
        payload = store.get(entry.key)
    except SwapCorrupt:
        _bump(counts, "corrupt")
        return None
    cols, meta = deserialize_columns(payload)
    overlay = {k: cols.get(k) for k in ("mem", "glob_lo", "glob_hi",
                                        "tab", "edrop", "ddrop")}
    overlay["mem_pages"] = meta.get("mem_pages")
    overlay["tsize"] = meta.get("tsize")
    return overlay
