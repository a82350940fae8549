"""Device -> host outcall channel: serve the lanes parked at host calls.

A trimmed copy of `wasmedge_tpu/batch/hostcall.py` `serve_batch_state`
over torch tensors, and the host half of the TPU kernel's `h_hostcall`
(`wasmedge_tpu/batch/pallas_engine.py` `_serve_hostcalls`, :4538, in the
per-lane form of the SIMT engine).  A lane that calls an imported
function parks at its HOSTCALL stub (trap = TRAP_HOSTCALL, frame pushed,
arguments at stack[fp ...]); between launches the engine calls
`serve_batch_state`, which runs every parked lane's host function and
re-arms it at the stub's RETURN with the results at stack[opbase ...].

Lanes are grouped by imported function, in ascending function index.
A group whose WASI function has a vectorized implementation
(host/wasi/vectorized.py) is served by one call over all its lanes; any
other group lane by lane in ascending lane order, through the same
host-function layer (runtime/hostfunc.py) the scalar engine calls.

Transfers: the argument rows come down as one slab; guest memory as
4 KiB-row chunks of the parked lanes' columns (gathered on the device, as
the Pallas host half gathers its parked lanes, pallas_engine.py
:4585-4597), each fetched once when first touched and written back once
if dirty; results, pc, sp and trap as row or vector updates.  No
per-lane transfer and no whole-plane round trip.

Tier 0 (`flush_stdout_buffers`, the reference's hostcall.py:214-283):
fd_write calls that the kernel retired left records in each lane's
in-device stdout buffer (`so_buf`: a header `fd << 28 | len`, then the
payload padded to words); the flush writes them to the WASI environ's
fds, lane by lane within each fd and fd by fd in sorted order, before
every serve round (a tier-1 call must see the bytes written before it)
and at the end of a run, and sets each lane's fill (`so_off`) to 0.  On
the card the records are cut out by a kernel (`csrc/stdout_flush.cu`,
`batch/stdout_flush.py`) and come down as one copy of the bytes; on the
CPU by `_records`, its plain version.
Exactly once across restores (the reference's :134-164): each lane's
records advance its logical stream position, and bytes below the
engine's written high-water mark are a replay of output already flushed
and are skipped (`_stdout_cursor`; `batch/checkpoint.py` journals the
position).  The reference's effects stream (gateway request streams,
also fed by tier-1 fd_write, :165-213) is not ported, so only tier-0
records move the cursor, as in the reference without it.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from wasmedge_tpu_torch.batch.image import TRAP_HOSTCALL
from wasmedge_tpu_torch.common.errors import ErrCode, TrapError
from wasmedge_tpu_torch.host.wasi.environ import WasiExit
from wasmedge_tpu_torch.host.wasi.vectorized import (
    VEC_WASI, MemView, NotVectorizable, _write_all)
from wasmedge_tpu_torch.runtime.instance import MemoryInstance

MASK32 = 0xFFFFFFFF
PAGE_WORDS = 65536 // 4


def serve_one(fi, args_cells: List[int],
              lane_mem: Optional[MemoryInstance]) -> Tuple[List[int], int]:
    """Run one lane's host call.  Returns (result_cells, trap_code)."""
    if fi.kind != "host":
        return [], int(ErrCode.ExecutionFailed)
    try:
        return fi.host.run(lane_mem, list(args_cells)), 0
    except TrapError as te:
        return [], int(te.code)
    except WasiExit:
        # proc_exit through the per-lane path: the lane terminates
        return [], int(ErrCode.Terminated)


def vec_impl_for(fi):
    """(vectorized_fn, environ) for a WASI host function with a
    vectorized implementation, else (None, None)."""
    host = getattr(fi, "host", None)
    env = getattr(host, "_env", None)
    if env is None or not hasattr(env, "get_fd"):
        return None, None
    return VEC_WASI.get(getattr(host, "name", None)), env


def gather_arg_cells(stack_lo, stack_hi, fp, lanes, nargs) -> np.ndarray:
    """Raw 64-bit argument cells [nargs, n] for a lane group (one fancy
    gather over the downloaded slab, no per-lane loop)."""
    n = int(lanes.size)
    if nargs == 0:
        return np.zeros((0, n), np.int64)
    rows = np.asarray(fp[lanes], np.int64)[None, :] + \
        np.arange(nargs, dtype=np.int64)[:, None]
    lo = stack_lo[rows, lanes[None, :]].view(np.uint32).astype(np.uint64)
    hi = stack_hi[rows, lanes[None, :]].view(np.uint32).astype(np.uint64)
    return (lo | (hi << np.uint64(32))).view(np.int64)


def _cells_to_planes(cells: np.ndarray):
    cu = cells.astype(np.uint64)
    lo = (cu & np.uint64(MASK32)).astype(np.uint32).view(np.int32)
    hi = (cu >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi


def wasi_env_of(engine):
    """The instance's WASI environ, found through any of its WASI host
    functions (None when it has none)."""
    for f in getattr(engine.inst, "funcs", None) or ():
        if getattr(f, "kind", None) == "host":
            env = getattr(getattr(f, "host", None), "_env", None)
            if env is not None and hasattr(env, "get_fd"):
                return env
    return None


def _stdout_cursor(engine, lanes: int):
    """Each lane's stdout stream cursor, behind exactly-once flushing
    across restores (the reference's hostcall.py:134-149).

    `pos[lane]` is the lane's logical stream position: the payload bytes
    its tier-0 fd_write records have reached in this run's replay order.
    `hw[lane]` is the high-water mark of the bytes written to the host
    fds.  A restore rewinds `pos` (checkpoint.load sets it to the
    journaled one) while `hw` stays on the engine, so replayed records
    are skipped up to the mark instead of written again."""
    cur = getattr(engine, "_stdout_cursor", None)
    if cur is None or cur[0].size != lanes:
        cur = (np.zeros(lanes, np.int64), np.zeros(lanes, np.int64))
        engine._stdout_cursor = cur
    return cur


def stdout_cursor_reset(engine, keep_highwater: bool = False):
    """Set the logical stream position to 0 (a fresh run, or a restore
    to the initial state).  `keep_highwater`: keep the written mark, so
    that a replay of the same run from its start prints nothing it has
    already flushed; False starts a new stream."""
    cur = getattr(engine, "_stdout_cursor", None)
    if cur is None:
        return
    cur[0][:] = 0
    if not keep_highwater:
        cur[1][:] = 0


def stdout_bytes(buf: np.ndarray, so_off: np.ndarray) -> dict:
    """fd -> the bytes of the stdout records in buf [rows, L] (each lane's
    rows below its fill so_off), lane after lane."""
    return _records(buf, so_off)[0]


def _records(buf: np.ndarray, so_off: np.ndarray, skip=None):
    """(fd -> record bytes lane after lane, each lane's payload bytes
    [L]) of the records in buf [rows, L] below each lane's fill so_off;
    `skip` [L]: the payload bytes at the head of each lane's records
    left out (a replay below the high-water mark).  When every lane with
    records holds them at the same rows with the same headers (the same
    lengths to the same fds) and none skips, they are cut out of the
    planes for all lanes at once; otherwise lane by lane."""
    lens = np.zeros(so_off.shape[0], np.int64)
    lanes = np.nonzero(so_off > 0)[0]
    if lanes.size == 0:
        return {}, lens
    cols = buf[:, lanes]
    first = cols[:, 0]
    layout = []  # lane 0's records: (header row, fd, length)
    off, end = 0, int(so_off[lanes[0]])
    while off < end:
        hdr = int(np.uint32(first[off]))
        layout.append((off, hdr >> 28, hdr & 0x0FFFFFFF))
        off += 1 + ((hdr & 0x0FFFFFFF) + 3) // 4
    hrows = [r for r, _, _ in layout]
    if (skip is None or not skip[lanes].any()) and \
            (so_off[lanes] == end).all() and \
            (cols[hrows] == first[hrows][:, None]).all():
        parts = {}
        for r, fd, ln in layout:
            words = np.ascontiguousarray(cols[r + 1:r + 1 + (ln + 3) // 4].T)
            parts.setdefault(fd, []).append(words.view(np.uint8)[:, :ln])
        lens[lanes] = sum(ln for _, _, ln in layout)
        return {fd: np.concatenate(p, axis=1).tobytes()
                for fd, p in parts.items()}, lens
    out = {}
    for i, lane in enumerate(lanes):
        k = 0 if skip is None else int(skip[lane])
        off, end = 0, int(so_off[lane])
        while off < end:
            hdr = int(np.uint32(cols[off, i]))
            ln = hdr & 0x0FFFFFFF
            nw = (ln + 3) // 4
            s = min(k, ln)
            k -= s
            if s < ln:
                out.setdefault(hdr >> 28, []).append(np.ascontiguousarray(
                    cols[off + 1:off + 1 + nw, i]).tobytes()[s:ln])
            lens[lane] += ln
            off += 1 + nw
    return {fd: b"".join(p) for fd, p in out.items()}, lens


def stdout_records(so_buf: torch.Tensor, so_off: torch.Tensor,
                   skip: np.ndarray) -> Optional[tuple]:
    """(fd -> the bytes of its records lane after lane, each lane's
    payload bytes [L] int64) of the records in the stdout plane so_buf
    [SW, L] below each lane's fill so_off, with each lane's first
    skip[lane] payload bytes left out; None when no lane has a record.
    CUDA tensors: the flush kernel (`batch/stdout_flush.py`, which raises
    when it cannot build or launch); CPU tensors: the plain version,
    `_records` over the rows below the largest fill."""
    if so_buf.device.type == "cuda":
        from wasmedge_tpu_torch.batch import stdout_flush

        return stdout_flush.records(so_buf, so_off, skip)
    if so_buf.device.type != "cpu":
        raise ValueError(f"no stdout flush for device {so_buf.device}")
    off = so_off.numpy()
    rows = int(off.max(initial=0))
    if rows == 0:
        return None
    return _records(so_buf[:rows].numpy(), off, skip)


def flush_stdout_buffers(engine, state) -> int:
    """Drain the tier-0 stdout records of `state` to the WASI environ's
    fds (`stdout_records`: on the card the flush kernel and one copy of
    the bytes to the host; one write per fd) and set every lane's fill to
    0, exactly once across restores: the records advance each lane's
    stream position, and bytes below the engine's written high-water mark
    are a replay of output a flush before the restore wrote, and are
    skipped (the reference's hostcall.py:214-283; payloads are
    deterministic unless a guest writes clock values, where the replayed
    window is printed at least once).  Returns the bytes written."""
    if state.so_buf is None:
        return 0
    t0 = time.perf_counter()
    pos, hw = _stdout_cursor(engine, int(state.so_off.shape[0]))
    res = stdout_records(state.so_buf, state.so_off, np.maximum(hw - pos, 0))
    if res is None:
        return 0
    per_fd, lens = res
    pos += lens
    np.maximum(hw, pos, out=hw)
    env = wasi_env_of(engine)
    nbytes = 0
    for fd in sorted(per_fd):
        e = env.fds.get(fd) if env is not None else None
        data = per_fd[fd]
        nbytes += len(data)
        if e is None or e.os_fd < 0:
            continue  # fd vanished (the tier-0 gate makes this unreachable)
        if data:
            _write_all(e, data)
    state.so_off.zero_()
    stats = engine.hostcall_stats
    stats["stdout_flushes"] += 1
    stats["stdout_bytes"] += nbytes
    stats["flush_s"] += time.perf_counter() - t0
    return nbytes


def serve_batch_state(engine, state, trap: Optional[np.ndarray] = None
                      ) -> int:
    """Serve every lane of `state` (a batch.engine.BatchState) parked at
    TRAP_HOSTCALL, updating the state in place; the buffered tier-0
    stdout is flushed first.  `trap`: the host's copy of the state's trap
    plane, when the caller has one (it is updated with the state's);
    else the plane is read.  Returns the number of lanes served (0 when
    none was parked)."""
    if trap is None:
        trap = state.trap.cpu().numpy()
    waiting = np.nonzero(trap == TRAP_HOSTCALL)[0]
    if waiting.size == 0:
        return 0
    flush_stdout_buffers(engine, state)
    t0 = time.perf_counter()
    img = engine.img
    stats = engine.hostcall_stats
    stats["serve_rounds"] += 1
    stats["tier1_calls"] += int(waiting.size)
    pc = state.pc.cpu().numpy()
    fp = state.fp.cpu().numpy()
    opbase = state.opbase.cpu().numpy()
    sp = state.sp.cpu().numpy().copy()
    pages = state.mem_pages.cpu().numpy().copy()
    has_mem = img.has_memory
    cache = PlaneMemoryCache(state.mem, waiting) if has_mem else None
    plane_cap = int(state.mem.shape[0]) // PAGE_WORDS if has_mem else 0
    new_trap = trap.copy()
    new_pc = pc.copy()
    use_vec = bool(engine.cfg.vectorized_hostcalls)

    ks = img.a[pc[waiting]]
    nargs_by_k = {int(k): len(engine.resolve_func(int(k)).functype.params)
                  for k in np.unique(ks)}
    nargs_arr = np.array([nargs_by_k[int(k)] for k in ks], np.int64)
    max_row = int((fp[waiting] + nargs_arr).max(initial=0))
    slab_lo = state.stack_lo[:max_row].cpu().numpy()
    slab_hi = state.stack_hi[:max_row].cpu().numpy()

    stack_sets = []  # (rows [nres, n], lanes [n], lo [nres, n], hi)
    for k in np.unique(ks):
        lanes = waiting[ks == k]
        fi = engine.resolve_func(int(k))
        nargs = nargs_by_k[int(k)]
        cells = codes = None
        if use_vec and has_mem and fi.kind == "host":
            vecfn, env = vec_impl_for(fi)
            if vecfn is not None:
                args = gather_arg_cells(slab_lo, slab_hi, fp, lanes, nargs)
                view = make_cached_view(cache, lanes, pages[lanes])
                try:
                    cells, codes = vecfn(env, view, args)
                except NotVectorizable:
                    cells = codes = None
        if cells is not None:
            stats["tier1_vectorized"] += int(lanes.size)
            ok = codes == 0
            okl = lanes[ok]
            nres = cells.shape[0]
            if okl.size and nres:
                rows = np.asarray(opbase[okl], np.int64)[None, :] + \
                    np.arange(nres, dtype=np.int64)[:, None]
                lo, hi = _cells_to_planes(cells[:, ok])
                stack_sets.append((rows, okl, lo, hi))
            sp[okl] = opbase[okl] + nres
            new_trap[lanes] = np.where(ok, 0, codes)
            new_pc[okl] = pc[okl] + 1  # resume at the stub's RETURN
            continue
        # per-lane fallback over chunk-cached lane memory views; a host
        # function that grows memory keeps to its module's ceiling
        max_pages = engine.mem_pages_max_of(int(k)) or None
        g_rows, g_lanes, g_cells = [], [], []
        for lane in lanes:
            base = int(fp[lane])
            args1 = []
            for i in range(nargs):
                lo = int(np.uint32(slab_lo[base + i, lane]))
                hi = int(np.uint32(slab_hi[base + i, lane]))
                args1.append(lo | (hi << 32))
            lane_mem = None
            if has_mem:
                lane_mem = _CachedLaneMemory(cache, int(lane), int(pages[lane]),
                                             max_pages, plane_cap)
            out, code = serve_one(fi, args1, lane_mem)
            if code:
                new_trap[lane] = code
                continue
            ob = int(opbase[lane])
            for i, cell in enumerate(out):
                g_rows.append(ob + i)
                g_lanes.append(int(lane))
                g_cells.append(cell & 0xFFFFFFFFFFFFFFFF)
            sp[lane] = ob + len(out)
            if has_mem:
                pages[lane] = lane_mem.pages  # the host may have grown it
            new_trap[lane] = 0
            new_pc[lane] = pc[lane] + 1  # resume at the stub's RETURN
        if g_rows:
            lo, hi = _cells_to_planes(np.asarray(g_cells, np.uint64))
            stack_sets.append((np.asarray(g_rows, np.int64)[None, :],
                               np.asarray(g_lanes, np.int64),
                               lo[None, :], hi[None, :]))

    dev = state.trap.device
    for rows, lanes_w, lo, hi in stack_sets:
        r = torch.as_tensor(rows, device=dev)
        c = torch.as_tensor(np.broadcast_to(lanes_w[None, :], rows.shape)
                            .copy(), device=dev)
        state.stack_lo[r, c] = torch.as_tensor(lo, device=dev)
        state.stack_hi[r, c] = torch.as_tensor(hi, device=dev)
    state.pc.copy_(torch.from_numpy(new_pc))
    state.sp.copy_(torch.from_numpy(sp))
    state.trap.copy_(torch.from_numpy(new_trap))
    trap[:] = new_trap
    if has_mem:
        cache.flush()  # dirty chunks only
        state.mem_pages.copy_(torch.from_numpy(pages))
    stats["serve_s"] += time.perf_counter() - t0
    return int(waiting.size)


# ---------------------------------------------------------------------------
# round-cached serving: memory views over the device plane
# ---------------------------------------------------------------------------
class PlaneMemoryCache:
    """Row-chunked host cache over the columns `lanes` (ascending) of a
    [W, L] memory plane for one serve round: a chunk of guest memory comes
    down for all those lanes at once (one gather on the device and one
    transfer per touched 4 KiB window, however many lanes read it),
    per-lane views slice columns out of the cached chunks, and each dirty
    chunk goes back in one scatter at flush.  A round that only reads
    guest memory uploads nothing."""

    CHUNK_ROWS = 1024  # 4 KiB of guest memory per chunk

    def __init__(self, mem_dev: torch.Tensor, lanes):
        self.dev = mem_dev
        self.W = int(mem_dev.shape[0])
        self.L = int(mem_dev.shape[1])
        lanes = np.asarray(lanes, np.int64)
        self._cols = torch.as_tensor(lanes, device=mem_dev.device)
        # lane -> its column in the cached chunks (-1: not cached)
        self.col = np.full(self.L, -1, np.int64)
        self.col[lanes] = np.arange(lanes.size)
        self._chunks = {}
        self._dirty = set()

    def _chunk(self, ci: int) -> np.ndarray:
        c = self._chunks.get(ci)
        if c is None:
            lo = ci * self.CHUNK_ROWS
            hi = min(lo + self.CHUNK_ROWS, self.W)
            c = self.dev[lo:hi].index_select(1, self._cols).cpu().numpy()
            self._chunks[ci] = c
        return c

    def read_bytes(self, lane: int, off: int, n: int) -> bytes:
        if n == 0:
            return b""
        w0 = off // 4
        w1 = (off + n - 1) // 4
        words = np.empty(w1 - w0 + 1, np.int32)
        w = w0
        while w <= w1:
            ci = w // self.CHUNK_ROWS
            base = ci * self.CHUNK_ROWS
            chunk = self._chunk(ci)
            upto = min(w1 + 1, base + chunk.shape[0])
            words[w - w0:upto - w0] = chunk[w - base:upto - base,
                                            self.col[lane]]
            w = upto
        raw = words.tobytes()
        start = off - w0 * 4
        return raw[start:start + n]

    def write_bytes(self, lane: int, off: int, data: bytes):
        n = len(data)
        if n == 0:
            return
        w0 = off // 4
        w1 = (off + n - 1) // 4
        cur = bytearray(self.read_bytes(lane, w0 * 4, (w1 - w0 + 1) * 4))
        start = off - w0 * 4
        cur[start:start + n] = data
        words = np.frombuffer(bytes(cur), dtype=np.int32)
        w = w0
        while w <= w1:
            ci = w // self.CHUNK_ROWS
            base = ci * self.CHUNK_ROWS
            chunk = self._chunk(ci)
            upto = min(w1 + 1, base + chunk.shape[0])
            chunk[w - base:upto - base, self.col[lane]] = \
                words[w - w0:upto - w0]
            self._dirty.add(ci)
            w = upto

    def flush(self):
        """Write the dirty chunks back to their columns of the device
        plane, one scatter each."""
        for ci in sorted(self._dirty):
            lo = ci * self.CHUNK_ROWS
            chunk = self._chunks[ci]
            self.dev[lo:lo + chunk.shape[0]].index_copy_(
                1, self._cols,
                torch.from_numpy(chunk).to(self.dev.device))
        self._dirty.clear()


class _CachedLaneMemory(MemoryInstance):
    """MemoryInstance view over one lane's column of a PlaneMemoryCache.
    `page_limit` is the plane's row capacity, so growth by a host
    function stays inside the allocation (rows beyond the current page
    count are zero)."""

    def __init__(self, cache: PlaneMemoryCache, lane: int, pages: int,
                 max_pages: Optional[int], page_limit: int):
        self._cache = cache
        self._lane = lane
        self._pages = pages
        self.min = pages
        self.max = max_pages
        self.page_limit = page_limit

    @property
    def pages(self) -> int:
        return self._pages

    def _nbytes(self) -> int:
        return self._pages * 65536

    def check_bounds(self, off: int, length: int):
        if off < 0 or off + length > self._nbytes():
            raise TrapError(ErrCode.MemoryOutOfBounds)

    def grow(self, delta: int) -> int:
        old = self._pages
        new = old + delta
        limit = self.page_limit
        if self.max is not None:
            limit = min(limit, self.max)
        if delta < 0 or new > limit or new > 65536:
            return -1
        self._pages = new
        return old

    def load(self, off: int, nbytes: int, signed: bool) -> int:
        self.check_bounds(off, nbytes)
        return int.from_bytes(
            self._cache.read_bytes(self._lane, off, nbytes), "little",
            signed=signed)

    def store(self, off: int, nbytes: int, value: int):
        self.check_bounds(off, nbytes)
        self._cache.write_bytes(
            self._lane, off,
            (value & ((1 << (8 * nbytes)) - 1)).to_bytes(nbytes, "little"))

    def load_bytes(self, off: int, n: int) -> bytes:
        self.check_bounds(off, n)
        return self._cache.read_bytes(self._lane, off, n)

    def store_bytes(self, off: int, data: bytes):
        self.check_bounds(off, len(data))
        self._cache.write_bytes(self._lane, off, bytes(data))

    def as_numpy(self) -> np.ndarray:
        return np.frombuffer(
            self._cache.read_bytes(self._lane, 0, self._nbytes()),
            dtype=np.uint8)


def make_cached_view(cache: PlaneMemoryCache, lanes, pages) -> MemView:
    """MemView over a PlaneMemoryCache: word gathers assemble from the
    cache's all-lane chunks (fetched on first touch); byte stores go
    through cache.write_bytes so dirty chunks are flushed."""

    class _CachedPlaneView(MemView):
        def _words(self, widx):
            widx = np.clip(np.asarray(widx, np.int64), 0, cache.W - 1)
            out = np.empty(widx.shape, np.int32)
            cr = PlaneMemoryCache.CHUNK_ROWS
            cis = widx // cr
            lanes = cache.col[self.lanes]
            cols = np.broadcast_to(lanes[None, :], widx.shape) \
                if widx.ndim == 2 else lanes
            for ci in np.unique(cis):
                chunk = cache._chunk(int(ci))
                m = cis == ci
                out[m] = chunk[widx[m] - int(ci) * cr, cols[m]]
            return out

        def _store_bytes_one(self, i, off, data):
            cache.write_bytes(int(self.lanes[i]), off, bytes(data))

    return _CachedPlaneView(lanes, pages)
