"""SoA-vectorized WASI implementations for the batch outcall channel.

A trimmed copy of `wasmedge_tpu/host/wasi/vectorized.py` (the tier-1
drain; no drain-latency recorder).  When the engine serves parked lanes
(batch/hostcall.py), lanes are grouped by hostcall id and each group of
a recognised WASI function is served by ONE vectorized NumPy call over
the lanes' memory columns instead of a per-lane loop through
host/wasi/wasifunc.py.  Semantics mirror the scalar functions (same
errno surface; a bad guest pointer is EFAULT).

Implementations receive:
  env   the group's WasiEnviron
  view  a MemView over the group's lane columns (vectorized byte access)
  args  int64 [nargs, n] raw argument cells

and return (results [nres, n] int64, trap_codes [n] int32).  Raising
NotVectorizable routes the whole group to the per-lane fallback loop
(sockets, iovec arrays longer than MAX_VEC_IOVS).
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np

from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.host.wasi.environ import WasiEnviron, WasiError
from wasmedge_tpu_torch.host.wasi.wasi_abi import Errno, Rights

MASK32 = 0xFFFFFFFF

# iovec arrays longer than this are rare enough that the per-lane loop
# is fine (and keeps the vectorized path's word gathers bounded)
MAX_VEC_IOVS = 8


class NotVectorizable(Exception):
    """Group cannot be served vectorized; use the per-lane loop."""


class MemView:
    """Vectorized byte accessor over a word-major int32 plane restricted
    to a set of lane columns.  `_words` and `_store_bytes_one` are the
    backend primitives (batch/hostcall.py make_cached_view)."""

    def __init__(self, lanes, pages):
        self.lanes = np.asarray(lanes, np.int64)
        self.n = int(self.lanes.size)
        self.pages = np.broadcast_to(
            np.asarray(pages, np.int64), (self.n,))

    # -- backend primitives -------------------------------------------------
    def _words(self, widx: np.ndarray) -> np.ndarray:
        """Gather int32 words: widx [k, n] row indices -> [k, n]."""
        raise NotImplementedError

    def _store_bytes_one(self, i: int, off: int, data: bytes):
        """Store bytes into view-lane i's memory at byte offset off."""
        raise NotImplementedError

    # -- shared vectorized layer --------------------------------------------
    def bounds_ok(self, off, ln) -> np.ndarray:
        off = np.asarray(off, np.uint64)
        ln = np.broadcast_to(np.asarray(ln, np.uint64), off.shape)
        end = off + ln
        return (end >= off) & (end <= self.pages.astype(np.uint64)
                               * np.uint64(65536))

    def load_u32(self, off) -> np.ndarray:
        off = np.asarray(off, np.int64)
        w0 = off >> 2
        ws = self._words(np.stack([w0, w0 + 1]))
        lo = ws[0].view(np.uint32).astype(np.uint64)
        hi = ws[1].view(np.uint32).astype(np.uint64)
        sh = ((off & 3) * 8).astype(np.uint64)
        return ((lo | (hi << np.uint64(32))) >> sh).astype(np.uint32)

    def gather_bytes(self, off, ln) -> list:
        """Per-lane bytes objects for ranges [off, off+ln); caller has
        bounds-checked.  One fancy gather covers every lane."""
        off = np.asarray(off, np.int64)
        ln = np.asarray(ln, np.int64)
        if self.n == 0:
            return []
        maxb = int(((off & 3) + ln).max(initial=0))
        if maxb == 0:
            return [b""] * self.n
        maxw = (maxb + 3) // 4
        idx = (off >> 2)[None, :] + np.arange(maxw, dtype=np.int64)[:, None]
        words = self._words(idx)                       # [maxw, n]
        raw = np.ascontiguousarray(words.T).view(np.uint8)  # [n, maxw*4]
        out = []
        for i in range(self.n):
            s = int(off[i] & 3)
            out.append(raw[i, s:s + int(ln[i])].tobytes())
        return out

    def store_u32(self, off, vals, mask=None):
        self._store_scalar(off, np.asarray(vals, np.uint64), 4, mask)

    def store_u64(self, off, vals, mask=None):
        self._store_scalar(off, np.asarray(vals, np.uint64), 8, mask)

    def _store_scalar(self, off, vals, nbytes, mask):
        off = np.asarray(off, np.int64)
        m = np.ones(self.n, bool) if mask is None \
            else np.asarray(mask, bool).copy()
        m &= np.asarray(self.bounds_ok(off, nbytes))
        for i in np.nonzero(m)[0]:
            self._store_bytes_one(
                int(i), int(off[i]),
                int(vals[i]).to_bytes(nbytes, "little"))

    def store_bytes(self, off, datas, mask=None):
        off = np.asarray(off, np.int64)
        m = np.ones(self.n, bool) if mask is None else np.asarray(mask, bool)
        for i in np.nonzero(m)[0]:
            if datas[i]:
                self._store_bytes_one(int(i), int(off[i]), datas[i])


# ---------------------------------------------------------------------------
# vectorized implementations
# ---------------------------------------------------------------------------
VEC_WASI: Dict[str, Callable] = {}


def _vec(name: str):
    def deco(fn):
        VEC_WASI[name] = fn
        return fn
    return deco


def _zeros_res(n: int, nres: int = 1):
    return np.zeros((nres, n), np.int64), np.zeros(n, np.int32)


@_vec("sched_yield")
def vec_sched_yield(env: WasiEnviron, view: MemView, args):
    os.sched_yield()
    return _zeros_res(view.n)


@_vec("proc_exit")
def vec_proc_exit(env: WasiEnviron, view: MemView, args):
    """Every lane in the group terminates (ErrCode.Terminated); the
    environ records the last lane's code like the scalar path records
    the (single) instance's."""
    env.exit_code = int(args[0][-1] & MASK32)
    env.exited = True
    res = np.zeros((0, view.n), np.int64)
    return res, np.full(view.n, int(ErrCode.Terminated), np.int32)


@_vec("clock_time_get")
def vec_clock_time_get(env: WasiEnviron, view: MemView, args):
    n = view.n
    ids = (args[0] & MASK32).astype(np.int64)
    ptrs = (args[2] & MASK32).astype(np.int64)
    res = np.zeros(n, np.int64)
    ok = np.ones(n, bool)
    times = np.zeros(n, np.uint64)
    for cid in np.unique(ids):
        m = ids == cid
        try:
            times[m] = np.uint64(env.clock_time(int(cid)))
        except WasiError as werr:
            res[m] = int(werr.errno)
            ok[m] = False
    bok = view.bounds_ok(ptrs, 8)
    res[ok & ~bok] = int(Errno.FAULT)
    view.store_u64(ptrs, times, ok & bok)
    return res.reshape(1, n), np.zeros(n, np.int32)


@_vec("random_get")
def vec_random_get(env: WasiEnviron, view: MemView, args):
    n = view.n
    bufs = (args[0] & MASK32).astype(np.int64)
    lens = (args[1] & MASK32).astype(np.int64)
    bok = np.asarray(view.bounds_ok(bufs, lens))
    res = np.where(bok, 0, int(Errno.FAULT)).astype(np.int64)
    total = int(lens[bok].sum())
    blob = os.urandom(total)
    datas = [b""] * n
    pos = 0
    for i in np.nonzero(bok)[0]:
        ln = int(lens[i])
        datas[i] = blob[pos:pos + ln]
        pos += ln
    view.store_bytes(bufs, datas, bok)
    return res.reshape(1, n), np.zeros(n, np.int32)


@_vec("fd_write")
def vec_fd_write(env: WasiEnviron, view: MemView, args):
    n = view.n
    fds = (args[0] & MASK32).astype(np.int64)
    iovs = (args[1] & MASK32).astype(np.int64)
    cnt = (args[2] & MASK32).astype(np.int64)
    nwp = (args[3] & MASK32).astype(np.int64)
    if int(cnt.max(initial=0)) > MAX_VEC_IOVS:
        raise NotVectorizable("iovec array too long")
    res = np.zeros(n, np.int64)
    live = np.ones(n, bool)

    # resolve fds once per distinct value; sockets keep scalar semantics
    entries = {}
    for fd in np.unique(fds):
        try:
            e = env.get_fd(int(fd), Rights.FD_WRITE)
        except WasiError as werr:
            m = fds == fd
            res[m] = int(werr.errno)
            live[m] = False
            continue
        if e.kind == "socket":
            raise NotVectorizable("socket write")
        entries[int(fd)] = e

    # iovec array bounds (scalar: _read_iovs check_bounds -> EFAULT)
    arr_ok = np.asarray(view.bounds_ok(iovs, 8 * cnt))
    res[live & ~arr_ok] = int(Errno.FAULT)
    live &= arr_ok

    datas = [[] for _ in range(n)]
    total = np.zeros(n, np.int64)
    for j in range(int(cnt.max(initial=0))):
        has = live & (j < cnt)
        if not has.any():
            break
        bufs = view.load_u32(iovs + 8 * j).astype(np.int64)
        lens = view.load_u32(iovs + 8 * j + 4).astype(np.int64)
        lens = np.where(has, lens, 0)
        dok = np.asarray(view.bounds_ok(bufs, lens))
        bad = has & ~dok
        # scalar: load_bytes faults -> EFAULT; earlier iovecs were
        # already written (same here: collected chunks still go out)
        res[bad] = int(Errno.FAULT)
        live &= dok | ~has
        lens = np.where(has & dok, lens, 0)
        chunks = view.gather_bytes(bufs, lens)
        for i in np.nonzero(has & dok)[0]:
            if chunks[i]:
                datas[i].append(chunks[i])
                total[i] += len(chunks[i])

    # one write per fd, lane-ascending (matches per-lane serve order)
    for fd, e in sorted(entries.items()):
        out = b"".join(b"".join(datas[i])
                       for i in np.nonzero(fds == fd)[0])
        _write_all(e, out)

    wrote = total.astype(np.uint64)
    np_ok = np.asarray(view.bounds_ok(nwp, 4))
    res[live & ~np_ok] = int(Errno.FAULT)
    view.store_u32(nwp, wrote, live & np_ok)
    return res.reshape(1, n), np.zeros(n, np.int32)


def _write_all(entry, data: bytes):
    off = 0
    while off < len(data):
        off += os.write(entry.os_fd, data[off:])
