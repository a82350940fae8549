"""B4, the memory window cache: `batch/memwin.py` and the plain interpreter with windows.

Unit cases hold `MemWindows` to the JAX rules (`_win_select`,
`_win_flush` of wasmedge_tpu/batch/pallas_engine.py :1779-1847): windows
invalid at the start, LRU replacement, a dirty victim written back before
the fill and a clean one never written, the single-resident-copy rule
(an incoming window that overlaps the other way writes that way back and
invalidates it first), bases clipped at W - CW, and the flush.

Per launch: the plain interpreter with `mem_window` against the same
interpreter without it, from the same state, on the window fixtures,
mem_checksum, coremark, the bulk zoo, vmix and the window host-call
module (serve round after every launch), in the per-op, blocks and super
encodings: every plane, every row, equal after every launch.

The windowed CUDA kernel needs the card: its test is marked `cuda` and
skips here (`chip_smoke.py` runs it at 256 lanes on every memory fixture).
"""

import os
import re

import numpy as np
import pytest
import torch

from wasmedge_tpu_torch.batch import interp_ref
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.hostcall import serve_batch_state
from wasmedge_tpu_torch.batch.interp import (
    LAUNCHES, device_tables, run_chunk)
from wasmedge_tpu_torch.batch.memwin import (
    HBM_WINDOW_ROWS, SENT, MemWindows)
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import trap as port_trap
from wasmedge_tpu_torch.executor.instantiate import (
    instantiate, register_import_object)
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import (
    build_coremark_kernel, build_memory_workload)
from wasmedge_tpu_torch.models.fixtures import (
    HOST_MODULE, build_bulk_zoo, build_vmix, build_window_host,
    build_window_pingpong, build_window_walk, bulk_zoo_args, host_env_funcs,
    window_pingpong_args)
from wasmedge_tpu_torch.runtime.hostfunc import ImportObject, PyHostFunction
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.validator import Validator

CW = HBM_WINDOW_ROWS
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "wasmedge_tpu_torch")


# -- MemWindows --------------------------------------------------------------

def _plane(W=4 * CW, L=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (W, L), dtype=torch.int32,
                         generator=g)


def _sel(win, lanes, rlo, rhi):
    t = lambda v: torch.as_tensor(v, dtype=torch.int32)  # noqa: E731
    return win.select(lanes, t(rlo), t(rhi))


def test_windows_start_invalid_and_fill_from_the_plane():
    mem = _plane()
    win = MemWindows(mem)
    assert (win.wb == SENT).all() and not win.wd.any()
    lanes = torch.arange(3)
    way = _sel(win, lanes, [5, 130, 300], [7, 132, 302])
    # first miss: mru 0 makes way 1 the victim; bases align8, clipped
    assert way.tolist() == [1, 1, 1]
    assert win.wb[1].tolist() == [0, 128, 296]
    for lane, r in ((0, 5), (1, 131), (2, 302)):
        got = win.read(lanes, way, torch.full((3,), r, dtype=torch.int32))
        assert int(got[lane]) == int(mem[r, lane])


def test_lru_replaces_the_least_recently_used_way():
    win = MemWindows(_plane(L=1))
    lane = torch.arange(1)
    assert _sel(win, lane, [0], [2]).tolist() == [1]      # A -> way 1
    assert _sel(win, lane, [130], [132]).tolist() == [0]  # B -> way 0
    assert _sel(win, lane, [4], [6]).tolist() == [1]      # A hits
    # C replaces B, the least recently used
    assert _sel(win, lane, [300], [302]).tolist() == [0]
    assert win.wb[:, 0].tolist() == [296, 0]
    assert int(win.mru[0]) == 0


def test_dirty_victim_is_written_back_and_a_clean_one_is_not():
    mem = _plane(L=2)
    win = MemWindows(mem)
    lanes = torch.arange(2)
    way = _sel(win, lanes, [10, 10], [12, 12])
    r = torch.full((2,), 11, dtype=torch.int32)
    # lane 0 writes, lane 1 only reads
    win.write(lanes, way, r, torch.tensor([77, 88], dtype=torch.int32),
              torch.tensor([True, False]))
    assert int(mem[11, 0]) != 77  # not yet in the plane
    mem[11, 1] = -5  # a clean way is never written back over the plane
    _sel(win, lanes, [300, 300], [302, 302])  # fills way 0
    _sel(win, lanes, [200, 200], [202, 202])  # evicts way 1 (rows 8..135)
    assert int(mem[11, 0]) == 77 and int(mem[11, 1]) == -5


def test_overlap_rule_writes_back_and_invalidates_the_other_way():
    mem = _plane(L=1)
    win = MemWindows(mem)
    lane = torch.arange(1)
    one = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
    way = _sel(win, lane, [0], [2])          # [0, 128) in way 1
    win.write(lane, way, one(127), one(1234), torch.tensor([True]))
    _sel(win, lane, [500], [502])            # [384, 512) in way 0
    _sel(win, lane, [3], [5])                # hit way 1: way 0 is the LRU
    # rows 126..128 do not fit [0, 128); the new window [120, 248) goes to
    # way 0 and overlaps way 1, which is written back and invalidated
    # before the fill, so the fill sees row 127's write
    way = _sel(win, lane, [126], [128])
    assert way.tolist() == [0] and win.wb[:, 0].tolist() == [120, SENT]
    assert int(mem[127, 0]) == 1234
    assert int(win.read(lane, way, one(127))[0]) == 1234


def test_window_base_is_clipped_at_w_minus_cw():
    W = 3 * CW + 8
    mem = _plane(W=W, L=1)
    win = MemWindows(mem)
    way = _sel(win, torch.arange(1), [W - 2], [W - 1])
    assert win.wb[int(way[0]), 0] == W - CW
    got = win.read(torch.arange(1), way,
                   torch.tensor([W - 1], dtype=torch.int32))
    assert int(got[0]) == int(mem[W - 1, 0])


def test_flush_writes_every_dirty_way_and_invalidates():
    mem = _plane(L=2)
    win = MemWindows(mem)
    lanes = torch.arange(2)
    for base, val in ((0, 11), (260, 22)):
        way = _sel(win, lanes, [base, base], [base + 2, base + 2])
        win.write(lanes, way, torch.full((2,), base + 1, dtype=torch.int32),
                  torch.full((2,), val, dtype=torch.int32),
                  torch.tensor([True, True]))
    win.flush()
    assert mem[1].tolist() == [11, 11] and mem[261].tolist() == [22, 22]
    assert (win.wb == SENT).all() and not win.wd.any()


def test_too_small_a_memory_has_no_window():
    with pytest.raises(ValueError):
        MemWindows(torch.zeros((CW - 1, 2), dtype=torch.int32))


def test_cuda_constants_match_python():
    src = open(os.path.join(PKG, "csrc", "memwin.cuh")).read()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert consts["WIN_ROWS"] == str(HBM_WINDOW_ROWS)
    assert consts["WIN_SENT"] == "-(1 << 30)" and SENT == -(1 << 30)
    # each thread's two ways of CW words, in the launch's one-warp blocks
    assert consts["WIN_SMEM_BYTES"] == "2 * WIN_ROWS * BLOCK_THREADS * 4"
    src = open(os.path.join(PKG, "csrc", "interp.cu")).read()
    assert re.search(r"constexpr int BLOCK_THREADS = (\d+);",
                     src).group(1) == "32"


# -- the plain interpreter with windows against it without -------------------

KN = dict(value_stack_depth=64, call_stack_depth=32, memory_pages_per_lane=3)
KV = dict(value_stack_depth=64, call_stack_depth=16, memory_pages_per_lane=1)

CASES = {
    "window_walk": (build_window_walk, "edgewalk",
                    lambda n: [np.arange(n) * 13 % 120 + 3], KN, 64),
    "window_pingpong": (build_window_pingpong, "pingpong",
                        lambda n: window_pingpong_args(n, 3), KV, 64),
    "mem_checksum": (build_memory_workload, "mem_checksum",
                     lambda n: [np.arange(n) * 9 + 1], KN, 64),
    "coremark": (build_coremark_kernel, "coremark",
                 lambda n: [np.arange(n) * 5 + 1], KN, 256),
    "bulk_fill": (build_bulk_zoo, "fill",
                  lambda n: bulk_zoo_args(n, "fill", 4), KN, 7),
    "bulk_copy": (build_bulk_zoo, "copy",
                  lambda n: bulk_zoo_args(n, "copy", 5), KN, 7),
    "vmix": (build_vmix, "vmix", lambda n: [np.arange(n) % 13 + 3], KV, 13),
}
SIMD = {"window_pingpong", "vmix"}


def _env_import():
    imp = ImportObject(HOST_MODULE)
    for name, (fn, params, results) in host_env_funcs(
            lambda: port_trap(0x95)).items():
        imp.add_func(name, PyHostFunction(fn, params, results))
    return imp


def _engine(data, lanes, knobs, imports=(), device="cpu"):
    conf = Configure()
    for k, v in knobs.items():
        setattr(conf.batch, k, v)
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    store = StoreManager()
    for imp in imports:
        register_import_object(store, imp)
    inst = instantiate(store, mod, conf)
    return BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                       device=device), inst


def _assert_equal(a, b, where):
    pa, pb = a.planes(), b.planes()
    assert pa.keys() == pb.keys()
    for f in pa:
        assert torch.equal(pa[f], pb[f]), f"plane {f}, {where}"


def windows_vs_direct(data, func, args, knobs, chunk, fusion, imports=None,
                      max_launches=400):
    """The plain interpreter with and without windows from one state,
    launch by launch (a serve round after each when `imports` is given):
    every plane equal.  Returns the final state and launch count."""
    lanes = len(np.asarray(args[0]))
    engs = [_engine(data, lanes, knobs, [f() for f in imports or ()])[0]
            for _ in (0, 1)]
    tabs = [device_tables(e.img, "cpu", fusion, mem_window=w)
            for e, w in zip(engs, (True, False))]
    st = engs[0].initial_state(engs[0].inst.exports[func][1], args)
    ref = st.clone()
    for launch in range(max_launches):
        interp_ref.run_chunk(tabs[0], st, chunk, False)
        interp_ref.run_chunk(tabs[1], ref, chunk, False)
        _assert_equal(st, ref, f"launch {launch}")
        if imports:
            assert serve_batch_state(engs[0], st) == \
                serve_batch_state(engs[1], ref)
            _assert_equal(st, ref, f"serve round after launch {launch}")
        if not bool((st.trap == 0).any()):
            return st, launch + 1
    raise AssertionError("still running after max_launches")


@pytest.mark.parametrize("fusion", ["none", "blocks", "super"])
@pytest.mark.parametrize("case", list(CASES))
def test_windows_equal_direct_every_launch(case, fusion):
    if fusion == "super" and case in SIMD:
        pytest.skip("superinstructions run only images without v128 ops")
    build, func, args, knobs, chunk = CASES[case]
    st, launches = windows_vs_direct(build(), func, args(8), knobs, chunk,
                                     fusion)
    assert launches >= 1 and (st.trap != 0).all()


@pytest.mark.parametrize("fusion", ["none", "blocks", "super"])
def test_window_host_call_sees_the_store(fusion):
    """A store and then a park in the same window: the launch's flush
    puts the store in the plane the serve round and the next launch
    read; 5x + 1 per lane."""
    x = np.arange(6) * 7 - 20
    st, launches = windows_vs_direct(build_window_host(), "f", [x], KV, 64,
                                     fusion, imports=[_env_import])
    assert launches == 3
    got = st.stack_lo[0].numpy().view(np.uint32)
    np.testing.assert_array_equal(got, (5 * x + 1) & 0xFFFFFFFF)


def test_plain_version_counts_no_launch():
    eng, _ = _engine(build_window_walk(), 4, KN)
    assert eng.tables.mem_window
    before = dict(LAUNCHES)
    res = eng.run("edgewalk", [np.full(4, 30)])
    assert (res.trap == -1).all() and LAUNCHES == before


@pytest.mark.cuda
def test_cuda_windows_match_plain_every_launch_all_rows():
    """On the card: the window-cache kernels (per-op and blocks) and the
    plain version from the same state, launch by launch, every plane and
    every row equal; the launches count as windowed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for case in ("window_walk", "window_pingpong", "mem_checksum",
                 "bulk_copy"):
        build, func, args, knobs, chunk = CASES[case]
        eng, inst = _engine(build(), 64, knobs, device="cuda")
        for fusion in ("none", "blocks"):
            tables = device_tables(eng.img, "cuda", fusion, mem_window=True)
            st = eng.initial_state(inst.exports[func][1], args(64))
            ref = st.clone()
            before = LAUNCHES["window"]
            for launch in range(400):
                run_chunk(tables, st, chunk, False)
                interp_ref.run_chunk(tables, ref, chunk, False)
                torch.cuda.synchronize()
                _assert_equal(st, ref, f"{case} {fusion} launch {launch}")
                if not bool((st.trap == 0).any()):
                    break
            assert LAUNCHES["window"] - before == launch + 1
