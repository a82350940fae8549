"""The value stack's low rows on chip: the launch geometry, and the fixtures that drive the rows across their edges.

The CUDA kernel keeps each lane's lowest R stack rows in its block's
shared memory for the whole launch (`csrc/interp.cu` `Lane`), loads the
rows below sp at entry and writes the rows it wrote back at every exit;
R follows from the depth (`batch/interp.py` `block_geometry`, the
kernel's `stack_rows` / `block_smem`).  The plain version
(`batch/interp_ref.py`) has no rows on chip: the planes after every
launch are the same.  The fixtures: a recursion whose stack crosses row
512 of a 1024-row stack and comes back (`build_deep_recursion`), three
host-call parks with live rows under each call (`build_host_rows`), and
a B3 rollback whose wrong path wrote the rows of two locals below sp
(`build_rollback_rows`).

Per launch: the reference SIMT `BatchEngine.run_from_state` and the
port's plain interpreter (with each serve round for the host calls; with
`optimistic` on and off for the rollback, stack rows below sp) from the
same image and state, every plane equal after every launch.  End of run:
results and traps against the reference Pallas kernel
(`PallasUniformEngine(..., interpret=True)`), bit-exact, and `retired`
too on the converged runs (ROADMAP.md §C2).

The kernel needs the card: its test is marked `cuda` and skips here
(`chip_smoke.py` holds it against the plain version on the H100, every
plane and row after every launch).
"""

import os
import re

import numpy as np
import pytest
import torch

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu_torch.batch import interp, interp_ref
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.interp import (
    block_geometry, device_tables, run_chunk)
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.executor.instantiate import instantiate
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models.fixtures import (
    build_deep_recursion, build_host_rows, build_rollback_rows)
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.validator import Validator
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_hostcall import (
    _env_import, _pallas_run as _host_pallas_run, _per_launch as
    _host_per_launch, _port_run as _host_port_run)
from tests.test_torch_interp import (
    _assert_planes, _assert_same_state, _image_of, _ref_planes)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "wasmedge_tpu_torch", "csrc")
DEEP = dict(value_stack_depth=1024, call_stack_depth=128,
            memory_pages_per_lane=1)
SHALLOW = dict(value_stack_depth=64, call_stack_depth=16,
               memory_pages_per_lane=1)


def _deep_args(lanes):
    return [np.arange(lanes) % 40 + 48]


def _rollback_args(lanes):
    return [np.random.default_rng(7).integers(0, 1 << 31, lanes)]


# -- the geometry ----------------------------------------------------------------

# (planes 4 = v128 cells, windows, depth) -> (stack rows on chip, dynamic
# shared bytes per block); 32 threads per block throughout
GEOMETRY = {
    (False, False, 256): (256, 65536),
    (False, False, 1024): (512, 131072),
    (False, False, 8192): (512, 131072),
    (False, True, 128): (128, 65536),
    (False, True, 1024): (512, 163840),
    (True, False, 64): (64, 32768),
    (True, False, 1024): (448, 229376),
    (True, True, 64): (64, 65536),
    (True, True, 1024): (384, 229376),
}


@pytest.mark.parametrize("simd, win, depth", list(GEOMETRY))
def test_block_geometry(simd, win, depth):
    rows, smem = GEOMETRY[simd, win, depth]
    g = block_geometry(depth, simd, win)
    assert g == {"threads_per_block": 32, "stack_rows": rows,
                 "smem_bytes": smem}
    assert smem <= interp.SMEM_BLOCK_MAX - interp.SMEM_STATIC


def test_geometry_constants_are_the_kernels():
    """block_geometry mirrors csrc/interp.cu and csrc/memwin.cuh."""
    src = open(os.path.join(CSRC, "interp.cu")).read() + \
        open(os.path.join(CSRC, "memwin.cuh")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("BLOCK_THREADS") == interp.BLOCK_THREADS
    assert const("SMEM_BLOCK_MAX") == interp.SMEM_BLOCK_MAX
    assert const("SMEM_STATIC") == interp.SMEM_STATIC
    assert const("STACK_ROWS_MAX") == interp.STACK_ROWS_MAX
    assert 2 * const("WIN_ROWS") * interp.BLOCK_THREADS * 4 == \
        interp.WIN_SMEM_BYTES


@pytest.mark.parametrize("depth, simd, win, split", [
    (256, False, False, False), (512, False, True, False),
    (513, False, False, True), (1024, False, False, True),
    (384, True, True, False), (385, True, True, True),
    (448, True, False, False), (None, False, False, True)])
def test_stack_split(depth, simd, win, split):
    """The build without the split runs depths whose rows all fit on
    chip; None (any depth) takes the split."""
    assert interp.stack_split(depth, simd, win) is split


def test_engine_tables_name_the_build_of_their_depth():
    """The engine's tables carry its depth's split into the build: the
    per-op build's define, the fused source's."""
    for depth, split in ((256, False), (1024, True)):
        conf = Configure()
        conf.batch.value_stack_depth = depth
        data = build_deep_recursion()
        mod = Validator(conf).validate(Loader(conf).parse_module(data))
        eng = BatchEngine(instantiate(StoreManager(), mod, conf),
                          conf=conf, lanes=2, device="cpu")
        assert eng.tables.stack_split is split
        assert f"#define WASM_STACK_SPLIT {int(split)}" in \
            eng.tables.fused_source
        assert f"-DWASM_STACK_SPLIT={int(split)}" in \
            interp._defines(False, False, split)


# -- per launch against the reference ---------------------------------------------

def _ref_engine(data, lanes, knobs, chunk):
    conf = RefConfigure()
    b = conf.batch
    b.steps_per_launch = chunk
    b.value_stack_depth = knobs["value_stack_depth"]
    b.call_stack_depth = knobs["call_stack_depth"]
    b.memory_pages_per_lane = knobs["memory_pages_per_lane"]
    b.fuse_superinstructions = False
    b.tierup = False
    _, store, inst = ref_instantiate(data, conf)
    return RefEngine(inst, store=store, conf=conf, lanes=lanes)


def _per_launch(data, func, args, lanes, knobs, chunk, max_launches=200):
    """The reference SIMT engine, the port's plain interpreter with
    `optimistic` on (one WarpState across the launches) and with it off,
    launch by launch: every plane equal after each, the careful port's
    all rows and the optimistic port's stack rows below sp.  Returns the
    careful port state, the WarpState and the deepest sp."""
    ref = _ref_engine(data, lanes, knobs, chunk)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    img = _image_of(ref.img)
    on = device_tables(img, "cpu", optimistic=True)
    off = device_tables(img, "cpu")
    port = state_from_reference(_ref_planes(st), device="cpu")
    opt = port.clone()
    warps = WarpState.new(lanes, "cpu")
    total, deepest = 0, 0
    for launch in range(max_launches):
        st, new_total = ref.run_from_state(st, total, total + chunk)
        run_chunk(off, port, chunk, False)
        run_chunk(on, opt, chunk, False, warps)
        want = _ref_planes(st)
        _assert_planes(port.to_numpy(), want, f"launch {launch}")
        assert_live_planes(opt.to_numpy(), want, f"on, launch {launch}")
        deepest = max(deepest, int(port.sp.max()))
        if new_total - total < chunk or not (want["trap"] == 0).any():
            return port, warps, deepest
        total = new_total
    raise AssertionError("reference still running after max_launches")


def test_deep_recursion_crosses_row_512_and_matches_simt():
    port, _, deepest = _per_launch(build_deep_recursion(), "deep",
                                   _deep_args(8), 8, DEEP, 97)
    assert (port.trap.numpy() == -1).all()
    rows = block_geometry(DEEP["value_stack_depth"], False, False)
    assert deepest > rows["stack_rows"] == 512


def test_rollback_rows_match_simt_and_roll_back():
    port, warps, _ = _per_launch(build_rollback_rows(), "f",
                                 _rollback_args(64), 64, SHALLOW, 64)
    assert (port.trap.numpy() == -1).all()
    assert warps.stats()["rollbacks"] >= 2


def test_host_rows_match_simt_every_serve_round():
    port, _, eng, calls = _host_per_launch(
        build_host_rows(), "f", [np.arange(8) * 13 - 40], 8,
        [_env_import("ref")], [_env_import("port")])
    assert (port.trap.numpy() == -1).all()
    assert eng.hostcall_stats["tier1_calls"] == 3 * 8
    assert calls >= 3


# -- end of run against the Pallas kernel -----------------------------------------

def _pallas_run(data, func, args, lanes, knobs):
    from wasmedge_tpu.batch.pallas_engine import PallasUniformEngine

    conf = RefConfigure()
    b = conf.batch
    b.steps_per_launch = 50_000
    b.value_stack_depth = knobs["value_stack_depth"]
    b.call_stack_depth = knobs["call_stack_depth"]
    b.memory_pages_per_lane = knobs["memory_pages_per_lane"]
    b.optimistic = False
    b.block_fusion = False
    b.fuse_superinstructions = False
    b.tierup = False
    _, store, inst = ref_instantiate(data, conf)
    eng = PallasUniformEngine(inst, store=store, conf=conf, lanes=lanes,
                              interpret=True)
    return eng.run(func, [np.asarray(a, np.int64) for a in args])


def _port_run(data, func, args, lanes, knobs):
    conf = Configure()
    for k, v in knobs.items():
        setattr(conf.batch, k, v)
    conf.batch.steps_per_launch = 4096
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    inst = instantiate(StoreManager(), mod, conf)
    eng = BatchEngine(inst, conf=conf, lanes=lanes, device="cpu")
    return eng.run(func, [np.asarray(a, np.int64) for a in args])


@pytest.mark.parametrize("case", ["deep_converged", "rollback_rows"])
def test_end_of_run_matches_pallas_kernel(case):
    if case == "deep_converged":
        data, func, args, knobs = (build_deep_recursion(), "deep",
                                   [np.full(8, 50)], DEEP)
    else:
        data, func, args, knobs = (build_rollback_rows(), "f",
                                   _rollback_args(8), SHALLOW)
    want = _pallas_run(data, func, args, 8, knobs)
    got = _port_run(data, func, args, 8, knobs)
    np.testing.assert_array_equal(got.trap, want.trap)
    assert (want.trap == -1).all()
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g, w)
    if case == "deep_converged":
        np.testing.assert_array_equal(got.retired, want.retired)


def test_host_rows_match_pallas_at_the_end():
    data, args = build_host_rows(), [np.arange(8) * 13 - 40]
    want = _host_pallas_run(data, "f", args, 8, [_env_import("ref")])
    got, _ = _host_port_run(data, "f", args, 8, [_env_import("port")])
    np.testing.assert_array_equal(got.trap, want.trap)
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g, w)


# -- the kernel on the card ---------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["deep", "rollback_rows"])
def test_cuda_stack_rows_match_plain_interpreter_every_launch(case):
    """On the card: the kernel, rows on chip, and the plain version from
    the same state, every plane and row after every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    data, func, args, knobs, chunk = (
        (build_deep_recursion(), "deep", _deep_args(64), DEEP, 97)
        if case == "deep" else
        (build_rollback_rows(), "f", _rollback_args(64), SHALLOW, 64))
    conf = Configure()
    for k, v in knobs.items():
        setattr(conf.batch, k, v)
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    inst = instantiate(StoreManager(), mod, conf)
    eng = BatchEngine(inst, conf=conf, lanes=64, device="cuda")
    st = eng.initial_state(inst.exports[func][1], args)
    ref = st.clone()
    wk, wp = (WarpState.new(64, "cuda") for _ in range(2))
    for _ in range(200):
        interp.run_chunk(eng.tables, st, chunk, False, wk)
        interp_ref.run_chunk(eng.tables, ref, chunk, False, wp)
        _assert_same_state(st, ref)
        if not bool((st.trap == 0).any()):
            break
