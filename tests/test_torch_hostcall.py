"""Host calls on the port against the reference engines.

Modules that import host functions (Python `env.*` functions and WASI)
run on both packages.  Three checks:

  - per launch: the reference's image and initial state are carried into
    the port (`wasmedge_tpu_torch.batch.convert`); the reference SIMT
    `BatchEngine.run_from_state` (tier 0, superinstruction fusion and
    tier-up off) and the port's plain engine each make one launch plus
    its serve round per call, and every plane must be bit-identical
    after every call;
  - end of run: results and traps against the reference Pallas kernel
    (`PallasUniformEngine(..., interpret=True)`) and the scalar oracle
    (`Executor.invoke`, one fresh instance per lane);
  - stdout: the bytes a WASI module writes through fd 1 must equal the
    reference SIMT run's and the scalar run's, lane after lane.

The CUDA kernel needs the card: its test is marked `cuda` and skips here.
"""

import os

import numpy as np
import pytest
import torch

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import ErrCode as RefErrCode
from wasmedge_tpu.common.errors import TrapError as RefTrapError
from wasmedge_tpu.common.errors import trap as ref_trap
from wasmedge_tpu.common.types import typed_to_bits
from wasmedge_tpu.host.wasi import WasiExit as RefWasiExit
from wasmedge_tpu.host.wasi import WasiModule as RefWasiModule
from wasmedge_tpu.runtime.hostfunc import ImportObject as RefImportObject
from wasmedge_tpu.runtime.hostfunc import PyHostFunction as RefPyHostFunction
from wasmedge_tpu_torch.batch import interp_ref
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.hostcall import serve_batch_state
from wasmedge_tpu_torch.batch.image import TRAP_HOSTCALL
from wasmedge_tpu_torch.batch.interp import device_tables, run_chunk
from wasmedge_tpu_torch.common.configure import Configure, HostRegistration
from wasmedge_tpu_torch.common.errors import ErrCode, InstantiationError
from wasmedge_tpu_torch.common.errors import trap as port_trap
from wasmedge_tpu_torch.executor.instantiate import (
    instantiate, register_import_object)
from wasmedge_tpu_torch.host.wasi import WasiModule
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import build_echo, build_wasi_hello
from wasmedge_tpu_torch.models.fixtures import (
    HOST_MODULE, build_host_double, build_host_grow, build_host_poke,
    build_host_trap, host_env_funcs)
from wasmedge_tpu_torch.models.programs import ECHO_MESSAGE, wasi_hello_output
from wasmedge_tpu_torch.runtime.hostfunc import ImportObject, PyHostFunction
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.utils.builder import ModuleBuilder
from wasmedge_tpu_torch.validator import Validator
from wasmedge_tpu_torch.vm.vm import VM
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_interp import (
    _assert_planes, _assert_same_state, _image_of, _ref_planes)

CHUNK = 64
D, CD, PAGES = 64, 16, 3
WASI_ARGS = ["alpha", "be"]


def _env_import(pkg: str):
    """The "env" host module of models.fixtures.host_env_funcs, built with
    either package's ImportObject and PyHostFunction."""
    if pkg == "ref":
        imp, fn_cls = RefImportObject(HOST_MODULE), RefPyHostFunction
        funcs = host_env_funcs(lambda: ref_trap(RefErrCode.ExecutionFailed))
    else:
        imp, fn_cls = ImportObject(HOST_MODULE), PyHostFunction
        funcs = host_env_funcs(lambda: port_trap(ErrCode.ExecutionFailed))
    for name, (fn, params, results) in funcs.items():
        imp.add_func(name, fn_cls(fn, params, results))
    return imp


def _wasi(pkg: str, fd: int):
    wasi = RefWasiModule() if pkg == "ref" else WasiModule()
    wasi.init_wasi(args=list(WASI_ARGS))
    wasi.env.fds[1].os_fd = fd
    return wasi


def _knobs(b, fuel=None, vectorized=True, chunk=CHUNK):
    b.steps_per_launch = chunk
    b.value_stack_depth, b.call_stack_depth = D, CD
    b.memory_pages_per_lane = PAGES
    b.fuel_per_launch = fuel
    b.vectorized_hostcalls = vectorized


def _ref_conf(**kw):
    conf = RefConfigure()
    _knobs(conf.batch, **kw)
    conf.batch.tier0_hostcalls = False
    conf.batch.fuse_superinstructions = False
    conf.batch.tierup = False
    return conf


def _port_engine(data, imports, lanes, **kw):
    conf = Configure()
    _knobs(conf.batch, **kw)
    store = StoreManager()
    for imp in imports:
        register_import_object(store, imp)
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    inst = instantiate(store, mod, conf)
    return BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                       device="cpu"), inst


def _per_launch(data, func, args, lanes, ref_imports, port_imports,
                max_calls=200, **kw):
    """Both engines from the same image and state, one launch and its
    serve round per call (`run_from_state` with a budget of one step);
    every plane equal after every call.  Returns (port state, reference
    engine, port engine, calls)."""
    conf = _ref_conf(**kw)
    _, store, inst = ref_instantiate(data, conf, imports=ref_imports)
    ref = RefEngine(inst, store=store, conf=conf, lanes=lanes)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    eng, _ = _port_engine(data, port_imports, lanes, **kw)
    eng.img = _image_of(ref.img)
    eng.tables = device_tables(eng.img, "cpu")
    port = state_from_reference(_ref_planes(st), device="cpu")
    total = 0
    for call in range(max_calls):
        st, total_ref = ref.run_from_state(st, total, total + 1)
        port, total_port = eng.run_from_state(port, total, total + 1)
        assert total_port == total_ref, f"call {call}"
        want, got = _ref_planes(st), port.to_numpy()
        _assert_planes(got, want, f"call {call}")
        assert not (got["trap"] == TRAP_HOSTCALL).any()
        total = total_ref
        if not (want["trap"] == 0).any():
            return port, ref, eng, call + 1
    raise AssertionError("reference still running after max_calls")


def _pallas_run(data, func, args, lanes, imports):
    from wasmedge_tpu.batch.pallas_engine import PallasUniformEngine

    conf = RefConfigure()
    _knobs(conf.batch, chunk=10_000)
    b = conf.batch
    b.optimistic = False
    b.block_fusion = False
    b.fuse_superinstructions = False
    b.tierup = False
    _, store, inst = ref_instantiate(data, conf, imports=imports)
    eng = PallasUniformEngine(inst, store=store, conf=conf, lanes=lanes,
                              interpret=True)
    assert eng.eligible, eng.ineligible_reason
    return eng.run(func, [np.asarray(a, np.int64) for a in args])


def _port_run(data, func, args, lanes, imports, **kw):
    eng, _ = _port_engine(data, imports, lanes, chunk=4096, **kw)
    return eng.run(func, [np.asarray(a, np.int64) for a in args]), eng


def _assert_same_end(got, want):
    np.testing.assert_array_equal(got.trap, want.trap)
    done = want.trap == -1
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g[done], w[done])


def _scalar(data, func, args, lane, imports):
    """(result cells, trap code) of the scalar oracle on one lane."""
    ex, store, inst = ref_instantiate(data, RefConfigure(), imports=imports)
    fi = inst.find_func(func)
    try:
        out = ex.invoke(store, fi, [int(a[lane]) for a in args])
    except RefTrapError as te:
        return None, int(te.code)
    except RefWasiExit:
        return None, int(RefErrCode.Terminated)
    return [typed_to_bits(t, v) for t, v in
            zip(fi.functype.results, out)], -1


def _assert_matches_scalar(res, data, func, args, lanes, make_imports):
    for lane in range(lanes):
        cells, code = _scalar(data, func, args, lane, make_imports())
        assert res.trap[lane] == code, (lane, res.trap[lane], code)
        for r, c in enumerate(cells or ()):
            assert int(res.results[r][lane]) & (2**64 - 1) == c, lane


# -- Python host functions -----------------------------------------------------

def _double_args(n):
    return [np.arange(n) * 10 - 7]


def _poke_args(n):
    return [np.arange(n) * 3 + 100]


def _trap_args(n):
    return [np.arange(n)]


def _grow_args(n):
    return [np.arange(n) % 5]  # 0..2 fit the 3-page plane, 3 and 4 do not


HOST_CASES = {
    "double": (build_host_double, _double_args, 8),
    "poke": (build_host_poke, _poke_args, 8),
    "host_trap": (build_host_trap, _trap_args, 8),
    "grow": (build_host_grow, _grow_args, 10),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_functions_match_simt_every_launch(case):
    build, args, lanes = HOST_CASES[case]
    port, _, eng, calls = _per_launch(
        build(), "f", args(lanes), lanes, [_env_import("ref")],
        [_env_import("port")])
    trap = port.trap.numpy()
    if case == "host_trap":
        assert trap[3] == int(ErrCode.ExecutionFailed)
        assert (np.delete(trap, 3) == -1).all()
    else:
        assert (trap == -1).all()
    assert eng.hostcall_stats["tier1_calls"] == lanes
    assert eng.hostcall_stats["tier1_vectorized"] == 0
    if case == "grow":
        assert port.mem_pages.tolist() == [1, 2, 3, 1, 1] * 2


@pytest.mark.parametrize("fuel", [2, 3, 4])
def test_fuel_running_out_at_the_stub_matches_simt(fuel):
    """double's third instruction is the HOSTCALL stub: fuel 3 runs out
    on the park itself, 2 just before it and 4 on the stub's RETURN."""
    port, _, eng, _ = _per_launch(
        build_host_double(), "f", _double_args(8), 8, [_env_import("ref")],
        [_env_import("port")], fuel=fuel)
    assert (port.trap.numpy() == int(ErrCode.CostLimitExceeded)).all()
    assert eng.hostcall_stats["serve_rounds"] == (0 if fuel < 3 else 1)


@pytest.mark.parametrize("case", ["double", "poke", "host_trap"])
def test_host_functions_match_pallas_and_scalar_at_the_end(case):
    build, args, lanes = HOST_CASES[case]
    data, a = build(), args(lanes)
    want = _pallas_run(data, "f", a, lanes, [_env_import("ref")])
    got, _ = _port_run(data, "f", a, lanes, [_env_import("port")])
    _assert_same_end(got, want)
    _assert_matches_scalar(got, data, "f", a, lanes,
                           lambda: [_env_import("ref")])


def test_host_grow_matches_scalar_within_the_plane():
    """Growth by a host function succeeds up to the plane's capacity
    (the page knob), as on the reference SIMT engine; the scalar oracle's
    memory has no such cap, so it is compared on the lanes that stay
    within it."""
    data, lanes = build_host_grow(), 10
    a = _grow_args(lanes)
    got, _ = _port_run(data, "f", a, lanes, [_env_import("port")])
    fits = np.nonzero(a[0] <= PAGES - 1)[0]
    for lane in fits:
        cells, code = _scalar(data, "f", a, lane, [_env_import("ref")])
        assert got.trap[lane] == code == -1
        assert int(got.results[0][lane]) == cells[0]
    big = a[0] > PAGES - 1
    assert (got.results[0][big] == (-1000 + 10 + 1) & 0xFFFFFFFF).all()


# -- WASI ----------------------------------------------------------------------

def _run_wasi_case(tmp_path, build, func, args, lanes, vectorized=True):
    """Per-launch run of a WASI module with each package's stdout in its
    own file; returns (port state, port engine, ref bytes, port bytes)."""
    paths = {k: tmp_path / f"{k}.out" for k in ("ref", "port")}
    fds = {k: os.open(p, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
           for k, p in paths.items()}
    try:
        port, _, eng, _ = _per_launch(
            build(), func, args, lanes, [_wasi("ref", fds["ref"])],
            [_wasi("port", fds["port"])], vectorized=vectorized)
    finally:
        for fd in fds.values():
            os.close(fd)
    return (port, eng, paths["ref"].read_bytes(),
            paths["port"].read_bytes())


def _scalar_stdout(tmp_path, data, func, args, lanes):
    """The scalar oracle's stdout, one fresh instance per lane, lanes in
    order; and the per-lane (cells, trap)."""
    path = tmp_path / "scalar.out"
    out = []
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
    try:
        for lane in range(lanes):
            out.append(_scalar(data, func, args, lane, [_wasi("ref", fd)]))
    finally:
        os.close(fd)
    return path.read_bytes(), out


@pytest.mark.parametrize("vectorized", [True, False])
def test_wasi_echo_matches_simt_and_scalar(tmp_path, vectorized):
    lanes, iters = 8, 2
    port, eng, ref_out, port_out = _run_wasi_case(
        tmp_path, build_echo, "echo", [np.full(lanes, iters)], lanes,
        vectorized)
    assert (port.trap.numpy() == -1).all()
    assert (port.stack_lo[0].numpy() == 0).all()  # fd_write's errno
    assert port_out == ref_out == ECHO_MESSAGE * (2 * iters * lanes)
    scalar, _ = _scalar_stdout(tmp_path, build_echo(), "echo",
                               [np.full(lanes, iters)], lanes)
    assert port_out == scalar  # the same bytes, lane after lane
    stats = eng.hostcall_stats
    assert stats["tier1_calls"] == 2 * iters * lanes
    assert stats["tier1_vectorized"] == (stats["tier1_calls"]
                                         if vectorized else 0)


def test_wasi_hello_exits_with_lane_codes(tmp_path):
    lanes = 12
    codes = np.arange(lanes) % 3
    port, _, ref_out, port_out = _run_wasi_case(
        tmp_path, build_wasi_hello, "hello", [codes], lanes)
    trap = port.trap.numpy()
    assert (trap == int(ErrCode.Terminated)).all()
    # proc_exit's argument stays in the parked frame: the lane's exit code
    fp = port.fp.numpy()
    assert (port.stack_lo.numpy()[fp, np.arange(lanes)] == codes).all()
    want = b"".join(wasi_hello_output(["wasm"] + WASI_ARGS, int(c))
                    for c in codes)
    assert port_out == ref_out == want
    scalar, per_lane = _scalar_stdout(tmp_path, build_wasi_hello(), "hello",
                                      [codes], lanes)
    assert port_out == scalar
    assert all(code == int(RefErrCode.Terminated) for _, code in per_lane)


@pytest.mark.parametrize("build,func,lanes,iters", [
    (build_echo, "echo", 8, 2), (build_wasi_hello, "hello", 8, None)])
def test_wasi_matches_pallas_at_the_end(tmp_path, build, func, lanes, iters):
    a = [np.full(lanes, iters)] if iters else [np.arange(lanes) % 3]
    outs = {}
    for k in ("ref", "port"):
        fd = os.open(tmp_path / k, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
        try:
            if k == "ref":
                want = _pallas_run(build(), func, a, lanes, [_wasi(k, fd)])
            else:
                got, _ = _port_run(build(), func, a, lanes, [_wasi(k, fd)])
        finally:
            os.close(fd)
        outs[k] = (tmp_path / k).read_bytes()
    _assert_same_end(got, want)
    assert outs["port"] == outs["ref"]


def test_vm_runs_a_wasi_module_on_the_cpu(tmp_path):
    """The user's path: Configure.host_registrations, init_wasi, then
    execute_batch(..., device="cpu")."""
    conf = Configure()
    conf.host_registrations.add(HostRegistration.Wasi)
    vm = VM(conf)
    fd = os.open(tmp_path / "out", os.O_RDWR | os.O_CREAT | os.O_TRUNC)
    try:
        vm.wasi_module.init_wasi(args=list(WASI_ARGS))
        vm.wasi_module.env.fds[1].os_fd = fd
        vm.load_wasm(build_echo())
        vm.validate()
        vm.instantiate()
        res = vm.execute_batch("echo", [1], lanes=4, device="cpu")
    finally:
        os.close(fd)
    assert (res.trap == -1).all() and (res.results[0] == 0).all()
    assert (tmp_path / "out").read_bytes() == ECHO_MESSAGE * 8


def test_vm_register_import_object():
    vm = VM()
    vm.register_import_object(_env_import("port"))
    vm.load_wasm(build_host_double())
    vm.validate()
    vm.instantiate()
    res = vm.execute_batch("f", [np.arange(4)], lanes=4, device="cpu")
    assert res.results[0].tolist() == [1, 3, 5, 7]


def test_import_resolution_errors_match_reference_codes():
    b = ModuleBuilder()
    b.import_func(HOST_MODULE, "double", ["i64"], ["i32"])  # wrong type
    b.add_function([], [], [], [])
    data = b.build()
    mod = Validator().validate(Loader().parse_module(data))
    store = StoreManager()
    with pytest.raises(InstantiationError) as unknown:
        instantiate(store, mod)
    assert unknown.value.code == ErrCode.UnknownImport
    register_import_object(store, _env_import("port"))
    with pytest.raises(InstantiationError) as wrong:
        instantiate(store, mod)
    assert wrong.value.code == ErrCode.IncompatibleImportType


def test_parked_lanes_are_served_when_the_budget_runs_out():
    """max_steps ends the run with lanes parked: they are served once, so
    the caller never sees TRAP_HOSTCALL."""
    eng, inst = _port_engine(build_host_double(), [_env_import("port")], 4)
    st = eng.initial_state(inst.exports["f"][1], [np.arange(4)])
    st, total = eng.run_from_state(st, 0, 3)
    assert (st.trap.numpy() == 0).all()
    ob = st.opbase.numpy()
    assert (st.stack_lo.numpy()[ob, np.arange(4)] == np.arange(4) * 2).all()
    assert (st.sp.numpy() == ob + 1).all()
    assert eng.hostcall_stats["serve_rounds"] == 1
    assert serve_batch_state(eng, st) == 0  # nothing parked: no round
    assert eng.hostcall_stats["serve_rounds"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(HOST_CASES) + ["wasi_echo",
                                                     "wasi_hello"])
def test_cuda_kernel_matches_plain_version_with_serve_rounds(tmp_path, case):
    """On the card: kernel and plain version from the same state, each
    with its own engine, host modules and serve round after every launch,
    every plane equal around every round and the stdout bytes equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    lanes = 32
    if case.startswith("wasi_"):
        build, func, args = {
            "wasi_echo": (build_echo, "echo", [np.full(lanes, 2)]),
            "wasi_hello": (build_wasi_hello, "hello",
                           [np.arange(lanes) % 3])}[case]
    else:
        build, make_args, _ = HOST_CASES[case]
        func, args = "f", make_args(lanes)
    paths = [tmp_path / k for k in ("kernel", "plain")]
    fds = [os.open(p, os.O_RDWR | os.O_CREAT | os.O_TRUNC) for p in paths]
    try:
        engs = []
        for fd in fds:
            imp = _wasi("port", fd) if case.startswith("wasi_") \
                else _env_import("port")
            eng, inst = _port_engine(build(), [imp], lanes)
            eng.device = torch.device("cuda")
            eng.tables = device_tables(eng.img, eng.device)
            engs.append(eng)
        st = engs[0].initial_state(inst.exports[func][1], args)
        ref = st.clone()
        for _ in range(50):
            run_chunk(engs[0].tables, st, CHUNK, False)
            interp_ref.run_chunk(engs[0].tables, ref, CHUNK, False)
            _assert_same_state(st, ref)
            serve_batch_state(engs[0], st)
            serve_batch_state(engs[1], ref)
            _assert_same_state(st, ref)
            if not bool((st.trap == 0).any()):
                break
    finally:
        for fd in fds:
            os.close(fd)
    assert paths[0].read_bytes() == paths[1].read_bytes()
