"""The port's front end against the reference's: same bytes in, same
device image out.

Loader -> Validator -> instantiate -> build_device_image in both packages
over the workloads, a module with call_indirect, globals, a table and
a data segment, and modules that import WASI or Python host functions
(their HOSTCALL/RETURN stubs), use memory.fill and memory.copy or use
v128 ops (constants and shuffle masks in the `v128` table); every numpy
field of the port's DeviceImage (the `v128` table and the tier-0 `t0kind`
plane included) and every scalar field (`has_simd` and `t0_fdwrite_safe`
included) must equal the reference's field of the same name, bit for
bit, and the handler-id plane must equal the Pallas engine's.  The WASI
fixtures include the tier-0 zoo (every tier-0 kind) and a module whose
fd_close makes fd_write unsafe.
"""

import numpy as np
import pytest

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.batch.image import build_device_image as ref_build
from wasmedge_tpu.batch.pallas_engine import hid_plane as ref_hid_plane
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu_torch.batch.engine import BatchEngine, _table_snapshot
from wasmedge_tpu_torch.batch.image import (
    CLS_MEMGROW, DeviceImage, build_device_image)
from wasmedge_tpu_torch.batch.interp import hid_plane
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import ErrCode, InstantiationError
from wasmedge_tpu_torch.executor.instantiate import (
    instantiate, register_import_object)
from wasmedge_tpu_torch.host.wasi import WasiModule
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import (
    build_bulk_workload, build_coremark_kernel, build_echo, build_fac,
    build_fib, build_loop_sum, build_memory_workload, build_wasi_hello)
from wasmedge_tpu_torch.models.fixtures import (
    build_alu_edge, build_bulk_zoo, build_host_grow, build_host_poke,
    build_simd_host, build_simd_sweep, build_tier0_unsafe, build_tier0_zoo,
    build_trap_zoo, build_v128_mem_zoo, build_vmix, simd_sweeps)
from wasmedge_tpu_torch.models.programs import build_simd_loop
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.utils.builder import ModuleBuilder
from wasmedge_tpu_torch.validator import Validator
from wasmedge_tpu.host.wasi import WasiModule as RefWasiModule
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_hostcall import _env_import

MODULES = {
    "fib": build_fib, "fac": build_fac, "loop_sum": build_loop_sum,
    "mem_checksum": build_memory_workload, "coremark": build_coremark_kernel,
    "call_indirect_globals_table_data": build_trap_zoo,
    "alu_edge": build_alu_edge,
    "wasi_echo": build_echo, "wasi_hello": build_wasi_hello,
    "wasi_tier0_zoo": build_tier0_zoo, "wasi_tier0_unsafe": build_tier0_unsafe,
    "host_poke": build_host_poke, "host_grow": build_host_grow,
    "bulk_zoo": build_bulk_zoo, "bulk_workload": build_bulk_workload,
    "vmix": build_vmix, "vloop": build_simd_loop,
    "simd_sweep_lanes": lambda: build_simd_sweep(simd_sweeps()["lanes_0"]),
    "v128_mem_zoo": build_v128_mem_zoo, "host_simd": build_simd_host,
}


def _imports(name, pkg):
    """The host modules a fixture imports, from either package."""
    if name.startswith("wasi_"):
        return [RefWasiModule() if pkg == "ref" else WasiModule()]
    if name.startswith("host_"):
        return [_env_import(pkg)]
    return []


def _port_inst(data, conf=None, imports=()):
    conf = conf or Configure()
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    store = StoreManager()
    for imp in imports:
        register_import_object(store, imp)
    return store, instantiate(store, mod, conf)


def _assert_same(img, ref, memgrow_ceiling=False):
    """Every field equal; with `memgrow_ceiling` (an engine's image) the
    `b` of each memory.grow is the page ceiling, which the reference
    reads from its image's mem_pages_max."""
    for f in DeviceImage.NUMPY_FIELDS:
        want = np.asarray(getattr(ref, f))
        if f == "b" and memgrow_ceiling:
            want = want.copy()
            want[np.asarray(ref.cls) == CLS_MEMGROW] = ref.mem_pages_max
        got = getattr(img, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in DeviceImage.SCALAR_FIELDS:
        assert getattr(img, f) == getattr(ref, f), f


@pytest.mark.parametrize("name", list(MODULES))
def test_device_image_equals_reference(name):
    data = MODULES[name]()
    _, rstore, rinst = ref_instantiate(data, imports=_imports(name, "ref"))
    ref = ref_build(rinst.lowered, memories=rinst.memories,
                    globals_=rinst.globals,
                    table0=RefEngine._table_snapshot(rinst, rstore),
                    mod=rinst.ast)
    store, inst = _port_inst(data, imports=_imports(name, "port"))
    img = build_device_image(inst.lowered, memories=inst.memories,
                             globals_=inst.globals,
                             table0=_table_snapshot(inst, store),
                             mod=inst.ast)
    _assert_same(img, ref)
    np.testing.assert_array_equal(hid_plane(img), ref_hid_plane(ref))


@pytest.mark.parametrize("name", ["coremark", "call_indirect_globals_table_data"])
def test_engine_image_clamps_pages_like_reference(name):
    """The engines clamp the declared page maximum by the knob alike."""
    data = MODULES[name]()
    rconf = RefConfigure()
    rconf.batch.memory_pages_per_lane = 2
    _, rstore, rinst = ref_instantiate(data, rconf)
    ref = RefEngine(rinst, store=rstore, conf=rconf, lanes=4).img
    conf = Configure()
    conf.batch.memory_pages_per_lane = 2
    store, inst = _port_inst(data, conf)
    img = BatchEngine(inst, store=store, conf=conf, lanes=4,
                      device="cpu").img
    _assert_same(img, ref, memgrow_ceiling=True)
    assert img.mem_pages_max == 2


def _refused(body, memory=True, table=False, passive=None):
    b = ModuleBuilder()
    if memory:
        b.add_memory(1, 1)
    if passive is not None:
        b.add_passive_data(passive)
        b.data_count = 1
    if table:
        b.add_table("funcref", 1)
    b.add_function([], [], [], body, export="f")
    store, inst = _port_inst(b.build())
    return lambda: BatchEngine(inst, store=store, lanes=2, device="cpu")


def test_classes_outside_the_slice_are_refused_by_name():
    """Every class of the encoding runs now (the table, segment and
    tail-call classes since the tables slice): memory.init and table.size
    build an engine, and a class beyond CLS_REFFUNC is refused by name."""
    from wasmedge_tpu_torch.batch.image import SLICE_MAX_CLASS, slice_refusal

    eng = _refused([("i32.const", 0), ("i32.const", 0), ("i32.const", 2),
                    ("memory.init", 0, 0)], passive=b"ab")()
    assert eng.tables.a3 and eng.img.cls.max() == SLICE_MAX_CLASS - 4
    eng = _refused([("table.size", 0), "drop"], memory=False, table=True)()
    assert eng.tables.a3 and not eng.tables.tmut
    eng.img.cls[0] = SLICE_MAX_CLASS + 1
    assert "(51)" in slice_refusal(eng.img)


def test_imports_and_start_functions_are_refused():
    """Imports of every kind resolve against registered modules: an
    unknown one is the reference's UnknownImport (a function and a
    memory here), and a module with a start function is no longer
    refused: the start function runs at instantiation (it sets the
    global the batch image then starts from)."""
    b = ModuleBuilder()
    b.import_func("env", "f", [], [])
    b.add_function([], [], [], [("call", 0)], export="g")
    mod = Validator().validate(Loader().parse_module(b.build()))
    with pytest.raises(InstantiationError) as err:
        instantiate(StoreManager(), mod)
    assert err.value.code == ErrCode.UnknownImport
    b = ModuleBuilder()
    b.import_memory("env", "mem", 1, 1)
    b.add_function([], [], [], [], export="g")
    mod = Validator().validate(Loader().parse_module(b.build()))
    with pytest.raises(InstantiationError) as err:
        instantiate(StoreManager(), mod)
    assert err.value.code == ErrCode.UnknownImport
    b = ModuleBuilder()
    g = b.add_global("i32", True, [("i32.const", 0)])
    b.add_function([], [], [], [("i32.const", 7), ("global.set", g)])
    b.set_start(0)
    mod = Validator().validate(Loader().parse_module(b.build()))
    inst = instantiate(StoreManager(), mod)
    assert inst.globals[0].value == 7


def test_v128_ops_are_refused():
    """The batchable v128 set is admitted; the v128 forms the reference
    does not batch (load-extend, load-splat, load-zero) are refused by
    name."""
    _refused([("v128.const", 0), "drop"], memory=False)()
    for op in ("v128.load8x8_s", "v128.load32_splat", "v128.load32_zero"):
        make = _refused([("i32.const", 0), (op, 0, 0), "drop"])
        with pytest.raises(ValueError, match=f"unsupported op {op}"):
            make()
