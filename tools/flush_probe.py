"""Tier 0's stdout flush on one GPU: where its time goes, the flush kernel against its plain version, and tier0_call's frame.

Run from the root of a checkout:  python3 tools/flush_probe.py [--no-frame]

WASI echo(4) x 4096 (bench_echo's shape) runs to its end in one launch of
the main path's build (B2 blocks, windows, optimistic, tier 0): 32,768
fd_write records in the stdout plane.  Then chip_smoke.py's
`phase_time_flush` on those planes, FLUSH_REPS times each (medians):

  - the plain path, as `flush_stdout_buffers` ran before the flush
    kernel: the `so_off` download, the download of the `so_buf` rows
    below the largest fill, `_records`, and the fd writes
    (`time.perf_counter` around each);
  - the kernel path: `flush_stdout_buffers` whole, and its parts: the
    launch, the read-back of the counts (its wait for the kernel
    included), the copy of the bytes into pinned memory, the fd writes;
    the kernel's device time (CUDA events around a launch queued behind
    a spin of the card, `chip_smoke.flush_device_ms`);
  - the library yardstick: `torch.masked_select` over a uint8 view of
    the transposed planes with a mask of the payload bytes (the stream of
    a batch whose lanes hold one layout; echo writes to fd 1 only), and
    the transpose before it.

The kernel's bytes and lens are held against `_records` on the echo
planes, on the tier-0 zoo's `digit` lanes at 4096 lanes (fd 1 and 2,
lengths of 1-3 bytes, lane-dependent record counts) and on random
planes with random skips.  Then `ptxas -v`'s rows for `tier0_call` (its
stack frame and spills) in the echo build and in the per-op tier-0
library (--no-frame leaves those builds out).  Prints the card's name
and power limit; the last line is a JSON object of everything.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

# the host link of an H100 SXM: PCIe Gen5 x16, 64 GB/s each way
# (published)
LINK_BYTES_PER_S = 64e9


def echo_state(fd):
    """(engine, state) of echo(ECHO_ITERS) x MAIN_LANES after its one
    launch to the end, its records in the stdout plane."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.batch.engine import t0_time_planes
    from wasmedge_tpu_torch.models import build_echo

    L = cs.MAIN_LANES
    eng = cs.make_engine(build_echo(), L, imports=[cs.wasi_import(fd)],
                         value_stack_depth=64, call_stack_depth=16,
                         memory_pages_per_lane=1)[0]
    st = eng.initial_state(eng.inst.exports["echo"][1],
                           [np.full(L, cs.ECHO_ITERS)])
    interp.run_chunk(eng.tables, st, 1 << 20, False, cs.new_warps(eng),
                     t0_time_planes())
    torch.cuda.synchronize()
    if not bool((st.trap == -1).all()):
        cs.fail("echo did not finish in one launch")
    return eng, st


def check(so_buf, so_off, skip, what) -> int:
    """The kernel against `_records` on the same planes; returns the
    bytes compared."""
    from wasmedge_tpu_torch.batch import stdout_flush
    from wasmedge_tpu_torch.batch.hostcall import _records

    got = stdout_flush.records(so_buf, so_off, skip)
    off = so_off.cpu().numpy()
    rows = int(off.max(initial=0))
    if rows == 0:
        if got is not None:
            cs.fail(f"{what}: the kernel found records in an empty plane")
        return 0
    want, lens = _records(so_buf[:rows].cpu().numpy(), off, skip)
    g = {fd: bytes(b) for fd, b in got[0].items() if len(b)}
    w = {fd: b for fd, b in want.items() if b}
    if g != w or not np.array_equal(got[1], lens):
        cs.fail(f"{what}: kernel {[(k, len(v)) for k, v in g.items()]} "
                f"!= plain {[(k, len(v)) for k, v in w.items()]} or lens "
                f"differ")
    return sum(len(v) for v in w.values())


def zoo_planes():
    """The tier-0 zoo's digit lanes x MAIN_LANES after one launch."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.batch.engine import t0_time_planes
    from wasmedge_tpu_torch.models.fixtures import build_tier0_zoo, tier0_cases

    L = cs.MAIN_LANES
    func, args = tier0_cases(L, cs.SEED)["digit"]
    eng = cs.make_engine(build_tier0_zoo(), L, imports=[cs.wasi_import(1)],
                         value_stack_depth=64, call_stack_depth=16,
                         memory_pages_per_lane=1)[0]
    st = eng.initial_state(eng.inst.exports[func][1], args)
    interp.run_chunk(eng.tables, st, 1 << 16, False, cs.new_warps(eng),
                     t0_time_planes())
    return st


def random_planes(rng, L=cs.MAIN_LANES, SW=64):
    buf = rng.integers(-2**31, 2**31, (SW, L)).astype(np.int32)
    off = np.zeros(L, np.int32)
    for lane in range(L):
        o = 0
        for _ in range(int(rng.integers(0, 6))):
            fd, ln = int(rng.integers(1, 3)), int(rng.integers(0, 41))
            nw = (ln + 3) // 4
            if o + 1 + nw > SW:
                break
            buf[o, lane] = ln | (fd << 28)
            o += 1 + nw
        off[lane] = o
    skip = np.where(rng.random(L) < 0.5, rng.integers(0, 60, L), 0)
    return torch.from_numpy(buf).cuda(), torch.from_numpy(off).cuda(), skip


def tier0_call_rows(ptxas: str) -> dict:
    """ptxas -v's stack frame and spill bytes of tier0_call."""
    lines = ptxas.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and "tier0_call" in line:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", lines[i + 1])
            if m:
                return dict(stack_frame=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
    return {"missing": True}


def main() -> int:
    if not torch.cuda.is_available():
        print("flush_probe: no CUDA device", flush=True)
        return 2
    from wasmedge_tpu_torch.batch import interp, stdout_flush
    from wasmedge_tpu_torch.models import build_echo

    card = cs.gpu_name_and_power()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    stdout_flush.build()
    print(f"flush kernel built in {stdout_flush.BUILD_INFO['seconds']:.1f} "
          f"s (command {time.perf_counter() - t0:.1f} s); ptxas: "
          f"{stdout_flush.BUILD_INFO['ptxas'].strip()}", flush=True)
    out = dict(card=card, build=dict(stdout_flush.BUILD_INFO))
    with tempfile.TemporaryDirectory() as td:
        fd = os.open(os.path.join(td, "out"), os.O_RDWR | os.O_CREAT)
        try:
            eng, st = echo_state(fd)
            flush = cs.phase_time_flush(eng, st)
            skip = np.zeros(st.so_off.shape[0], np.int64)
            compared = check(st.so_buf, st.so_off, skip, "echo")
            rng = np.random.default_rng(cs.SEED)
            compared += check(st.so_buf, st.so_off,
                              rng.integers(0, 40, st.so_off.shape[0]),
                              "echo, random skips")
            zoo = zoo_planes()
            compared += check(zoo.so_buf, zoo.so_off,
                              np.zeros(zoo.so_off.shape[0], np.int64),
                              "zoo digit")
            compared += check(zoo.so_buf, zoo.so_off,
                              rng.integers(0, 3, zoo.so_off.shape[0]),
                              "zoo digit, skips")
            for k in range(3):
                compared += check(*random_planes(rng), f"random planes {k}")
        finally:
            os.close(fd)
    link_ms = flush["flush_bytes"] / LINK_BYTES_PER_S * 1e3
    print(f"the copy of the stream to the host: {link_ms:.6f} ms at "
          f"{LINK_BYTES_PER_S:.3g} B/s; kernel == plain on {compared} B",
          flush=True)
    out.update(flush, link_ms=link_ms, compared_bytes=compared)

    # tier0_call's frame: the echo build and the per-op tier-0 library
    rows = {}
    for fusion in () if "--no-frame" in sys.argv else ("blocks", "none"):
        tb = cs.make_engine(build_echo(), 2, device="cpu",
                            imports=[cs.wasi_import(1)], fusion=fusion,
                            value_stack_depth=64, call_stack_depth=16,
                            memory_pages_per_lane=1)[0].tables
        interp.build_kernels([tb], per_op=())
        if fusion == "none":
            info = interp.BUILD_INFO["per_op"][interp.per_op_label(
                tb.mem_window, tb.optimistic, tb.stack_split,
                interp.one_key(tb))]
        else:
            info = interp.BUILD_INFO["fused"][interp.fused_kernel_key(tb)]
        rows[fusion] = tier0_call_rows(info.get("ptxas", ""))
        print(f"tier0_call in the {fusion} echo build: {rows[fusion]}",
              flush=True)
    out["tier0_call"] = rows
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
