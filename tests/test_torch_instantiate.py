"""Full instantiation on the port against the JAX package's `Executor`.

- start functions: run once the instance is in the store, their writes
  to memory, globals and the table kept, a trap in them raised from
  `instantiate` with the JAX package's code (and the instance already
  registered);
- imported tables, memories and globals from a registered module and
  from a host module (`ImportObject.add_table` / `add_memory` /
  `add_global`), written through by the importer's segments and start
  function; limit matching (`_limits_match`) over a grid of provided and
  required limits, `UnknownImport` and `IncompatibleImportType`: the same
  error code, or none, on both sides;
- after `instantiate`, every instance's memory bytes, globals and table
  refs equal the JAX instance's;
- the linked program (`models.fixtures.build_linked_program`) at 64
  lanes and small n on the CPU: the device image the port builds from
  its instance (imported memory, table and globals, the start
  function's writes) equals the JAX engine's; then per launch against
  the JAX SIMT `BatchEngine.run_from_state` (fusion and tier-up off),
  per-op and in B2 blocks, `optimistic` and `mem_hbm` on and off, every
  plane; and at the end of the run `VM.execute_batch` against the JAX
  `VM.execute_batch` and the numpy model: results, traps and `retired`.
"""

import numpy as np
import pytest

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import WasmError as RefWasmError
from wasmedge_tpu.common.types import ValType as RefValType
from wasmedge_tpu.executor import Executor as RefExecutor
from wasmedge_tpu.loader import Loader as RefLoader
from wasmedge_tpu.loader import ast as ref_ast
from wasmedge_tpu.runtime import instance as ref_instance
from wasmedge_tpu.runtime.hostfunc import ImportObject as RefImportObject
from wasmedge_tpu.runtime.store import StoreManager as RefStore
from wasmedge_tpu.validator import Validator as RefValidator
from wasmedge_tpu.vm.vm import VM as RefVM
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.image import DeviceImage
from wasmedge_tpu_torch.batch.interp import device_tables
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import ErrCode, WasmError
from wasmedge_tpu_torch.common.types import ValType
from wasmedge_tpu_torch.executor import Executor
from wasmedge_tpu_torch.executor.instantiate import instantiate
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.loader import ast
from wasmedge_tpu_torch.models.fixtures import (
    build_linked_program, linked_args, linked_program_model, linked_words)
from wasmedge_tpu_torch.runtime import instance
from wasmedge_tpu_torch.runtime.hostfunc import ImportObject
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.utils.wat import parse_wat
from wasmedge_tpu_torch.validator import Validator
from wasmedge_tpu_torch.vm.vm import VM
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_interp import _assert_planes, _ref_planes

LANES = 64
N0, N1 = 6, 3  # run's trip counts at 64 lanes: 6 .. 27
CHUNK = 97


class Side:
    """One package's staging: a store and an Executor, modules registered
    by name, instantiation with the error code caught."""

    def __init__(self, pkg):
        self.pkg = pkg
        if pkg == "port":
            self.conf, self.store = Configure(), StoreManager()
            self.ex = Executor(self.conf)
        else:
            self.conf, self.store = RefConfigure(), RefStore()
            self.ex = RefExecutor(self.conf)

    def module(self, data):
        if self.pkg == "port":
            return Validator(self.conf).validate(
                Loader(self.conf).parse_module(data))
        return RefValidator(self.conf).validate(
            RefLoader(self.conf).parse_module(data))

    def register(self, name, data):
        return self.ex.register_module(self.store, self.module(data), name)

    def host(self, build):
        imp = build(self.pkg)
        return self.ex.register_import_object(self.store, imp)

    def instantiate(self, data, name=""):
        """The instance, or ("error", code)."""
        try:
            return self.ex.instantiate(self.store, self.module(data), name)
        except (WasmError, RefWasmError) as e:
            return ("error", int(e.code))


def _state(inst, store):
    """An instance's memory bytes, globals (type, value) and table refs,
    each ref as its handle and the function's index in its module."""
    def ref(h):
        fi = store.deref_func(h)
        return (h, None if fi is None else fi.func_idx)

    return dict(
        mems=[bytes(m.data) for m in inst.memories],
        pages=[(m.pages, m.max) for m in inst.memories],
        globals=[(int(g.type.val_type), g.type.mutable, g.value)
                 for g in inst.globals],
        tables=[(t.size, t.max, [ref(h) for h in t.refs])
                for t in inst.tables],
        elems=[list(e.refs) for e in inst.elems],
        datas=[bytes(d.data) for d in inst.datas],
    )


def _both(steps):
    """Run `steps(side)` on both packages; each returns a list of
    instances or ("error", code); the states (or codes) must be equal."""
    out = []
    for pkg in ("port", "ref"):
        side = Side(pkg)
        res = steps(side)
        out.append([r if isinstance(r, tuple) else _state(r, side.store)
                    for r in res])
    assert out[0] == out[1]
    return out[0]


PROVIDER = """(module
  (memory (export "mem") 1 3)
  (table (export "tab") 3 5 funcref)
  (global (export "g") i32 (i32.const 41))
  (global (export "gm") (mut i64) (i64.const -7))
  (func $p (export "p") (result i32) (i32.const 5))
  (elem (i32.const 2) $p)
  (data (i32.const 8) "prov"))"""

CONSUMER = """(module
  (import "prov" "mem" (memory 1))
  (import "prov" "tab" (table 2 funcref))
  (import "prov" "g" (global $g i32))
  (import "prov" "gm" (global $gm (mut i64)))
  (global $own (mut i32) (global.get $g))
  (func $a (result i32) (i32.const 1))
  (func $b (result i32) (i32.const 2))
  (elem (i32.const 0) $a $b)
  (data (i32.const 0) "cons")
  (func $start
    (i32.store (i32.const 100) (i32.add (global.get $g) (i32.const 1)))
    (global.set $gm (i64.add (global.get $gm) (i64.const 1000)))
    (global.set $own (i32.mul (global.get $own) (i32.const 3)))
    (table.set (i32.const 1) (ref.func $a)))
  (start $start)
  (func (export "sum") (result i32)
    (i32.add (call_indirect (result i32) (i32.const 0))
             (call_indirect (result i32) (i32.const 1)))))"""


def test_imports_of_every_kind_and_a_start_function():
    def steps(side):
        prov = side.register("prov", parse_wat(PROVIDER))
        cons = side.instantiate(parse_wat(CONSUMER))
        return [prov, cons]

    prov, cons = _both(steps)
    # the consumer wrote into the provider's memory, table and global
    assert prov["mems"][0][:4] == b"cons" and prov["mems"][0][8:12] == b"prov"
    assert int.from_bytes(prov["mems"][0][100:104], "little") == 42
    assert prov["globals"][1][2] == (-7 + 1000) & ((1 << 64) - 1)
    assert cons["globals"][2][2] == 123
    assert cons["mems"] == prov["mems"] and cons["tables"] == prov["tables"]


def test_start_function_trap_propagates_after_registration():
    src = """(module (memory 1) (global $g (mut i32) (i32.const 0))
      (func $s (global.set $g (i32.const 9))
        (i32.store (i32.const 65534) (i32.const 1)))
      (start $s))"""
    for pkg in ("port", "ref"):
        side = Side(pkg)
        got = side.instantiate(parse_wat(src), name="m")
        assert got == ("error", int(ErrCode.MemoryOutOfBounds))
        # registered before the start function ran, its write kept
        inst = side.store.find_module("m")
        assert inst is not None and inst.globals[0].value == 9
    anon = Side("port")
    anon.instantiate(parse_wat(src))
    assert len(anon.store.anonymous) == 1


def _host_kinds(pkg):
    """A host module with a table, a memory and a global."""
    if pkg == "port":
        inst_mod, ast_mod, vt, cls = instance, ast, ValType, ImportObject
    else:
        inst_mod, ast_mod, vt, cls = ref_instance, ref_ast, RefValType, \
            RefImportObject
    imp = cls("host")
    tab = inst_mod.TableInstance(ast_mod.TableType(
        vt.FuncRef, ast_mod.Limit(2, 4)))
    mem = inst_mod.MemoryInstance(ast_mod.MemoryType(ast_mod.Limit(1, 2)))
    mem.data[0:4] = b"host"
    glob = inst_mod.GlobalInstance(ast_mod.GlobalType(vt.I64, True), 77)
    imp.add_table("tab", tab).add_memory("mem", mem).add_global("g", glob)
    imp.add_py_func("inc", lambda m, x: x + 1, ["i32"], ["i32"])
    return imp


HOST_USER = """(module
  (import "host" "tab" (table 2 funcref))
  (import "host" "mem" (memory 1 2))
  (import "host" "g" (global $g (mut i64)))
  (import "host" "inc" (func $inc (param i32) (result i32)))
  (func $f (result i32) (call $inc (i32.load (i32.const 0))))
  (elem (i32.const 1) $f)
  (func $s (global.set $g (i64.add (global.get $g) (i64.const 1)))
    (i32.store (i32.const 4) (call $inc (i32.const 9))))
  (start $s)
  (func (export "go") (result i32) (call_indirect (result i32) (i32.const 1))))"""


def test_host_module_with_a_table_memory_and_global():
    def steps(side):
        host = side.host(_host_kinds)
        inst = side.instantiate(parse_wat(HOST_USER))
        return [host, inst]

    host, user = _both(steps)
    assert host["globals"] == [(int(ValType.I64), True, 78)]
    assert host["mems"][0][4:8] == (10).to_bytes(4, "little")
    for pkg in ("port", "ref"):
        side = Side(pkg)
        side.host(_host_kinds)
        inst = side.instantiate(parse_wat(HOST_USER))
        out = side.ex.invoke(side.store, inst.find_func("go"), [])
        assert [int(v) for v in out] == [int.from_bytes(b"host", "little") + 1]


LIMITS = [(1, None), (1, 1), (1, 2), (2, None), (2, 3), (0, 0)]


@pytest.mark.parametrize("kind", ["memory", "table"])
@pytest.mark.parametrize("provided", LIMITS)
@pytest.mark.parametrize("required", LIMITS)
def test_limit_matching(kind, provided, required):
    def lim(mn, mx):
        return f"{mn}" + ("" if mx is None else f" {mx}")

    if kind == "memory":
        prov = f'(module (memory (export "x") {lim(*provided)}))'
        cons = f'(module (import "p" "x" (memory {lim(*required)})))'
    else:
        prov = f'(module (table (export "x") {lim(*provided)} funcref))'
        cons = f'(module (import "p" "x" (table {lim(*required)} funcref)))'

    def steps(side):
        side.register("p", parse_wat(prov))
        return [side.instantiate(parse_wat(cons))]

    (got,) = _both(steps)
    pmin, pmax = provided
    rmin, rmax = required
    fits = pmin >= rmin and (rmax is None or (pmax is not None
                                              and pmax <= rmax))
    assert (got == ("error", int(ErrCode.IncompatibleImportType))) == \
        (not fits)


IMPORT_ERRORS = {
    "no_module": ('(module (import "q" "x" (memory 1)))',
                  ErrCode.UnknownImport),
    "no_field": ('(module (import "p" "nope" (memory 1)))',
                 ErrCode.UnknownImport),
    "wrong_kind": ('(module (import "p" "mem" (table 1 funcref)))',
                   ErrCode.UnknownImport),
    "global_type": ('(module (import "p" "g" (global i64)))',
                    ErrCode.IncompatibleImportType),
    "global_mut": ('(module (import "p" "g" (global (mut i32))))',
                   ErrCode.IncompatibleImportType),
    "table_ref": ('(module (import "p" "tab" (table 1 externref)))',
                  ErrCode.IncompatibleImportType),
    "func_sig": ('(module (import "p" "f" (func (param i32))))',
                 ErrCode.IncompatibleImportType),
    "ok": ('(module (import "p" "g" (global i32)) '
           '(import "p" "f" (func (result i32))))', None),
}
IMPORT_PROVIDER = """(module (memory (export "mem") 1)
  (table (export "tab") 1 funcref) (global (export "g") i32 (i32.const 3))
  (func (export "f") (result i32) (i32.const 4)))"""


@pytest.mark.parametrize("case", sorted(IMPORT_ERRORS))
def test_import_errors(case):
    src, code = IMPORT_ERRORS[case]

    def steps(side):
        side.register("p", parse_wat(IMPORT_PROVIDER))
        return [side.instantiate(parse_wat(src))]

    (got,) = _both(steps)
    if code is None:
        assert not isinstance(got, tuple)
    else:
        assert got == ("error", int(code))


def test_register_module_name_conflict():
    for pkg in ("port", "ref"):
        side = Side(pkg)
        side.register("p", parse_wat(IMPORT_PROVIDER))
        with pytest.raises((WasmError, RefWasmError)) as err:
            side.register("p", parse_wat(IMPORT_PROVIDER))
        assert int(err.value.code) == int(ErrCode.ModuleNameConflict)


def test_the_thin_entry_point_runs_start_functions():
    prov, cons = build_linked_program()
    store = StoreManager()
    Executor().register_module(store, Side("port").module(prov), "prov")
    inst = instantiate(store, Side("port").module(cons))
    words = linked_words()
    mem = np.frombuffer(bytes(inst.memories[0].data[:4096]), np.uint32)
    assert (mem.astype(np.int64) == words).all()
    assert inst.globals[1].value == words[-1]


# ---------------------------------------------------------------------------
# the linked program on the batch engine
# ---------------------------------------------------------------------------
def _linked(pkg, conf):
    prov, cons = build_linked_program()
    side = Side(pkg)
    side.conf = conf
    side.ex = (Executor if pkg == "port" else RefExecutor)(conf)
    side.register("prov", prov)
    return side, side.instantiate(cons)


def _ref_conf():
    conf = RefConfigure()
    b = conf.batch
    b.steps_per_launch = CHUNK
    b.value_stack_depth, b.call_stack_depth = 64, 16
    b.fuse_superinstructions = False
    b.tierup = False
    return conf


def _port_conf(**knobs):
    conf = Configure()
    b = conf.batch
    b.steps_per_launch = CHUNK
    b.value_stack_depth, b.call_stack_depth = 64, 16
    for k, v in knobs.items():
        setattr(b, k, v)
    return conf


_TRAJ = {}


def _trajectory():
    """The JAX engine's image and its run launch by launch."""
    if not _TRAJ:
        conf = _ref_conf()
        side, inst = _linked("ref", conf)
        ref = RefEngine(inst, store=side.store, conf=conf, lanes=LANES)
        st = ref.initial_state(ref.export_func_idx("run"),
                               [np.asarray(a, np.int64)
                                for a in linked_args(LANES, N0, N1)])
        start, steps, total = _ref_planes(st), [], 0
        while (np.asarray(st.trap) == 0).any():
            st, total = ref.run_from_state(st, total, total + 1)
            steps.append((total, _ref_planes(st)))
        _TRAJ.update(img=ref.img, start=start, steps=steps)
    return _TRAJ


def test_linked_image_equals_jax():
    traj = _trajectory()
    conf = _port_conf()
    side, inst = _linked("port", conf)
    eng = BatchEngine(inst, store=side.store, conf=conf, lanes=LANES,
                      device="cpu")
    ref = traj["img"]
    for f in DeviceImage.NUMPY_FIELDS:
        np.testing.assert_array_equal(getattr(eng.img, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in DeviceImage.SCALAR_FIELDS:
        assert getattr(eng.img, f) == getattr(ref, f), f
    # imported memory (max 1 page), the start function's words, the
    # consumer's four functions in the imported table, $h0 after start
    words = linked_words()
    assert eng.img.mem_pages_max == 1 and eng.img.table_max == 0
    assert (eng.img.mem_init[:1024].astype(np.int64) & 0xFFFFFFFF
            == words).all()
    assert list(eng.img.table0) == [i + 1 for i in range(4)]
    assert int(eng.img.globals_lo[1]) & 0xFFFFFFFF == words[-1]


CONFIGS = [("none", None, None), ("none", False, False),
           ("none", None, False), ("blocks", None, None),
           ("blocks", False, False), ("blocks", False, None)]


@pytest.mark.parametrize("fusion,optimistic,mem_hbm", CONFIGS)
def test_linked_matches_simt_every_launch(fusion, optimistic, mem_hbm):
    from wasmedge_tpu_torch.batch.engine import mem_window_of, optimistic_of
    from wasmedge_tpu_torch.batch.optimistic import WarpState

    traj = _trajectory()
    conf = _port_conf(optimistic=optimistic, mem_hbm=mem_hbm)
    side, inst = _linked("port", conf)
    eng = BatchEngine(inst, store=side.store, conf=conf, lanes=LANES,
                      device="cpu")
    eng.tables = device_tables(
        eng.img, "cpu", fusion, mem_window=mem_window_of(mem_hbm, eng.img),
        optimistic=optimistic_of(optimistic), stack_depth=64)
    eng.warps = WarpState.new(LANES, "cpu") if eng.tables.optimistic \
        else None
    st = eng.initial_state(inst.exports["run"][1], linked_args(LANES, N0, N1))
    _assert_planes(st.to_numpy(), traj["start"], "initial state")
    port, total = state_from_reference(traj["start"], device="cpu"), 0
    for call, (want_total, want) in enumerate(traj["steps"]):
        port, total = eng.run_from_state(port, total, total + 1)
        at = f"linked [{fusion}, opt={optimistic}, hbm={mem_hbm}] launch {call}"
        assert total == want_total, at
        got = port.to_numpy()
        if fusion == "none" and not eng.tables.optimistic:
            _assert_planes(got, want, at)
        else:
            assert_live_planes(got, want, at)
    args = linked_args(LANES, N0, N1)
    res = port.stack_lo[0].numpy().astype(np.int64) & 0xFFFFFFFF
    assert (port.trap.numpy() == -1).all()
    assert (res == linked_program_model(*args)).all()
    assert (port.retired.numpy() == 8 + 35 * args[0]).all()
    assert eng.tables.mem_window == (mem_hbm is not False)


def test_linked_execute_batch_equals_jax_vm():
    args = linked_args(LANES, N0, N1)
    prov, cons = build_linked_program()
    vm = VM()
    vm.register_module("prov", prov)
    vm.load_wasm(cons)
    vm.validate()
    vm.instantiate()
    got = vm.execute_batch("run", args, lanes=LANES, device="cpu")
    rvm = RefVM(_ref_conf())
    rvm.register_module("prov", prov)
    rvm.load_wasm(cons).validate().instantiate()
    want = rvm.execute_batch("run", args, lanes=LANES)
    np.testing.assert_array_equal(got.trap, np.asarray(want.trap))
    np.testing.assert_array_equal(got.retired, np.asarray(want.retired))
    np.testing.assert_array_equal(
        np.asarray(got.results[0], np.int64) & 0xFFFFFFFF,
        np.asarray(want.results[0], np.int64) & 0xFFFFFFFF)
    assert ((np.asarray(got.results[0], np.int64) & 0xFFFFFFFF)
            == linked_program_model(*args)).all()
    # execute_batch wrote nothing back: the scalar engine still sees the
    # memory and globals the start function left, on both sides
    for lane in (0, 5, 63):
        a = [int(args[0][lane]), int(args[1][lane])]
        assert [v & 0xFFFFFFFF for v in vm.execute("run", a)] == \
            [v & 0xFFFFFFFF for v in rvm.execute("run", a)] == \
            [int(linked_program_model([a[0]], [a[1]])[0])]
