"""The port's multi-tenant images (batch/multitenant.py) against the JAX
package's on the CPU: the concatenated image field by field, the end of
a mixed run (the five cases of tests/test_multitenant.py through both
packages, the Pallas route in interpret mode among them), per-tenant
WASI environs, the B2 plan of a concatenated image, and ROADMAP C10:
each tenant's memory.grow keeps its own module's ceiling (the solo run,
the JAX Pallas route and the scalar engine agree; the JAX SIMT path
gives every tenant the largest one)."""

import numpy as np
import pytest

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.batch.multitenant import (
    MultiTenantBatchEngine as RefMultiTenant, Tenant as RefTenant,
    concat_images as ref_concat, run_mixed as ref_run_mixed)
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.executor import Executor as RefExecutor
from wasmedge_tpu.host.wasi import WasiModule as RefWasiModule
from wasmedge_tpu.host.wasi.wasi_abi import Rights
from wasmedge_tpu.loader import Loader as RefLoader
from wasmedge_tpu.runtime.hostfunc import ImportObject as RefImportObject
from wasmedge_tpu.runtime.hostfunc import PyHostFunction as RefPyHostFunction
from wasmedge_tpu.runtime.store import StoreManager as RefStore
from wasmedge_tpu.validator import Validator as RefValidator
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.fusion import H_BLOCK_BASE, fuse_blocks
from wasmedge_tpu_torch.batch.image import CLS_MEMGROW, DeviceImage
from wasmedge_tpu_torch.batch.interp import hid_plane
from wasmedge_tpu_torch.batch.multitenant import (
    MultiTenantBatchEngine, Tenant, concat_images, run_mixed)
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.executor import Executor
from wasmedge_tpu_torch.host.wasi import WasiModule
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import (
    build_coremark_kernel, build_fac, build_fib, build_loop_sum)
from wasmedge_tpu_torch.models.fixtures import (
    C10_MAX_PAGES, C10_PAGES_PER_LANE, build_clash_a, build_clash_b,
    build_grow_tenant, coremark_model, fac_model, fib_model, loop_sum_model,
    u32_cells)
from wasmedge_tpu_torch.runtime.hostfunc import ImportObject, PyHostFunction
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.utils.builder import ModuleBuilder
from wasmedge_tpu_torch.validator import Validator
from wasmedge_tpu_torch.vm.vm import VM

CHUNK = 5000


def _bump(pkg):
    imp = (ImportObject if pkg == "port" else RefImportObject)("env")
    imp.add_func("bump", (PyHostFunction if pkg == "port"
                          else RefPyHostFunction)(lambda mem, x: x + 1,
                                                  ["i32"], ["i32"]))
    return imp


def _host_module():
    hb = ModuleBuilder()
    hb.import_func("env", "bump", ["i32"], ["i32"])
    hb.add_function(["i32"], ["i32"], [],
                    [("local.get", 0), ("call", 0)], export="f")
    return hb.build()


def _div_module():
    tb = ModuleBuilder()
    tb.add_function(["i32", "i32"], ["i32"], [],
                    [("local.get", 0), ("local.get", 1), ("i32.div_s",)],
                    export="div")
    return tb.build()


def _i64(*v):
    return np.array(v, np.int64)


# (module, export, args, lanes, imports) per tenant: the cases of
# tests/test_multitenant.py, and config 5's four modules at a small size
CASES = {
    "three_modules": [
        (build_fib, "fib", [_i64(5, 8, 10, 11)], 4, None),
        (build_fac, "fac", [_i64(3, 6, 10)], 3, None),
        (build_loop_sum, "loop_sum", [_i64(10, 100, 1000, 17, 4)], 5, None)],
    "clash": [
        (build_clash_a, "go", [_i64(1, 2, 3)], 3, None),
        (build_clash_b, "go", [_i64(10, 20)], 2, None)],
    "host_traps": [
        (_host_module, "f", [_i64(100, 200)], 2, _bump),
        (_div_module, "div", [_i64(10, 9, 8), _i64(2, 0, 4)], 3, None)],
    "config5": [
        (build_fib, "fib", [_i64(3, 9, 12)], 3, None),
        (build_fac, "fac", [_i64(1, 7, 20, 13)], 4, None),
        (build_loop_sum, "loop_sum", [_i64(0, 31, 200)], 3, None),
        (build_coremark_kernel, "coremark", [_i64(5, 40)], 2, None)],
}
WANT = {
    "three_modules": [[5, 21, 55, 89], [6, 720, 3628800],
                      [45, 4950, 499500, 136, 6]],
    "clash": [[1005, 1010, 1015], [12, 22]],
}


def _conf(pkg, pages=None):
    conf = (Configure if pkg == "port" else RefConfigure)()
    conf.batch.steps_per_launch = CHUNK
    if pages is not None:
        conf.batch.memory_pages_per_lane = pages
    if pkg == "ref":
        conf.batch.use_pallas = False
        conf.batch.fuse_superinstructions = False
        conf.batch.tierup = False
    return conf


def inst_of(pkg, data, conf, imports=()):
    """(instance, store) of `data` in either package."""
    ld, vd, ex, st = ((Loader, Validator, Executor, StoreManager)
                      if pkg == "port" else
                      (RefLoader, RefValidator, RefExecutor, RefStore))
    mod = vd(conf).validate(ld(conf).parse_module(data))
    store = st()
    e = ex(conf)
    for imp in imports:
        e.register_import_object(store, imp)
    return e.instantiate(store, mod), store


def specs_of(pkg, rows, conf):
    """run_mixed's specs of `rows` (a CASES value) in either package."""
    out = []
    for build, func, args, lanes, imp in rows:
        inst, store = inst_of(pkg, build(), conf,
                              [imp(pkg)] if imp else ())
        out.append((inst, store, func, args, lanes))
    return out


def tenants_of(pkg, rows, conf):
    """Per-tenant engines and Tenants of `rows` in either package."""
    tenants = []
    for inst, store, func, args, lanes in specs_of(pkg, rows, conf):
        if pkg == "port":
            eng = BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                              device="cpu")
            tenants.append(Tenant(eng, func, args, lanes))
        else:
            eng = RefEngine(inst, store=store, conf=conf, lanes=lanes)
            tenants.append(RefTenant(eng, func, args, lanes))
    return tenants


def assert_image_equals_jax(img, ref, memgrow_b=None):
    """Every field of DeviceImage equal, but the `b` of memory.grow,
    which holds each tenant's own ceiling (`memgrow_b`) where the JAX
    image reads one image-wide value."""
    grow = img.cls == CLS_MEMGROW
    for f in DeviceImage.NUMPY_FIELDS:
        got = getattr(img, f)
        want = getattr(ref, f)
        if f == "t0kind":
            assert not got.any()  # no tier-0 plane: every call at tier 1
            continue
        want = np.asarray(want)
        if f == "b":
            np.testing.assert_array_equal(got[grow], memgrow_b)
            got, want = got[~grow], want[~grow]
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in DeviceImage.SCALAR_FIELDS:
        if f == "t0_fdwrite_safe":
            assert not img.t0_fdwrite_safe
            continue
        assert getattr(img, f) == getattr(ref, f), f


@pytest.mark.parametrize("case", list(CASES))
def test_concat_image_equals_jax(case):
    img, bases = concat_images(tenants_of("port", CASES[case], _conf("port")))
    ref, rbases = ref_concat(tenants_of("ref", CASES[case], _conf("ref")))
    assert bases == rbases
    assert_image_equals_jax(img, ref, memgrow_b=[])


def _assert_results_equal(got, want, case):
    assert len(got) == len(want)
    for ti, (g, w) in enumerate(zip(got, want)):
        at = f"{case} tenant {ti}"
        np.testing.assert_array_equal(g.trap, np.asarray(w.trap), at)
        np.testing.assert_array_equal(g.retired, np.asarray(w.retired), at)
        done = g.trap == -1
        for r, (gr, wr) in enumerate(zip(g.results, w.results)):
            np.testing.assert_array_equal(np.asarray(gr)[done],
                                          np.asarray(wr)[done], at)


@pytest.mark.parametrize("case", list(CASES))
def test_run_mixed_equals_jax(case):
    got = run_mixed(specs_of("port", CASES[case], _conf("port")),
                    conf=_conf("port"), max_steps=500_000, device="cpu")
    want = ref_run_mixed(specs_of("ref", CASES[case], _conf("ref")),
                         conf=_conf("ref"), max_steps=500_000)
    _assert_results_equal(got, want, case)
    for ti, r in enumerate(WANT.get(case, ())):
        assert got[ti].results[0].tolist() == r
    if case == "host_traps":
        assert got[0].results[0].tolist() == [101, 201]
        assert got[1].trap[1] == int(ErrCode.DivideByZero)
        assert got[1].results[0][[0, 2]].tolist() == [5, 2]
    if case == "config5":
        models = (fib_model, fac_model, loop_sum_model, coremark_model)
        for (_, _, args, _, _), model, r in zip(CASES[case], models, got):
            assert (r.trap == -1).all()
            np.testing.assert_array_equal(
                u32_cells(r.results[0]) if model is not fac_model
                else r.results[0], model(args[0]))


def test_pallas_route_equals_port():
    """test_pallas_multitenant_path's fixture: the JAX package runs it
    through its Pallas route (interpret mode); the port's one
    concatenated image gives the same results."""
    conf = RefConfigure()
    conf.batch.steps_per_launch = CHUNK
    conf.batch.interpret = True
    conf.batch.use_pallas = True
    tenants = []
    for build, func in ((build_fib, "fib"), (build_fac, "fac")):
        inst, store = inst_of("ref", build(), conf)
        tenants.append(RefTenant(
            RefEngine(inst, store=store, conf=conf, lanes=8), func,
            [np.full(8, 10, np.int64)], 8))
    mt = RefMultiTenant(tenants, conf=conf)
    want = mt.run_tenants(max_steps=200_000)
    assert mt.used_pallas
    pconf = _conf("port")
    specs = [(*inst_of("port", build(), pconf), func,
              [np.full(8, 10, np.int64)], 8)
             for build, func in ((build_fib, "fib"), (build_fac, "fac"))]
    got = run_mixed(specs, conf=pconf, max_steps=200_000, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.trap, np.asarray(w.trap))
        np.testing.assert_array_equal(g.results[0], np.asarray(w.results[0]))
    assert (got[0].results[0] == 55).all()
    assert (got[1].results[0] == 3628800).all()


def _reader(path_byte: int) -> bytes:
    """path_open of the one-byte path, fd_read of 4 bytes, their word
    (tests/test_multitenant.py's per-tenant WASI reader)."""
    rights = int(Rights.FILE_BASE | Rights.DIR_BASE)
    b = ModuleBuilder()
    b.import_func("wasi_snapshot_preview1", "path_open",
                  ["i32", "i32", "i32", "i32", "i32", "i64", "i64",
                   "i32", "i32"], ["i32"])
    b.import_func("wasi_snapshot_preview1", "fd_read",
                  ["i32", "i32", "i32", "i32"], ["i32"])
    b.add_memory(1, 1)
    b.add_function(["i32"], ["i32"], ["i32"], [
        ("i32.const", 100), ("i32.const", path_byte), ("i32.store8", 0, 0),
        ("i32.const", 3), ("i32.const", 1),
        ("i32.const", 100), ("i32.const", 1), ("i32.const", 0),
        ("i64.const", rights), ("i64.const", rights), ("i32.const", 0),
        ("i32.const", 200), ("call", 0),
        ("local.tee", 1),
        ("if", None),
        ("i32.const", 0), ("local.get", 1), "i32.sub", "return",
        "end",
        ("i32.const", 64), ("i32.const", 300), ("i32.store", 2, 0),
        ("i32.const", 68), ("i32.const", 4), ("i32.store", 2, 0),
        ("i32.const", 200), ("i32.load", 2, 0),
        ("i32.const", 64), ("i32.const", 1), ("i32.const", 0),
        ("call", 1),
        ("local.tee", 1),
        ("if", None),
        ("i32.const", -1000), ("local.get", 1), "i32.sub", "return",
        "end",
        ("i32.const", 300), ("i32.load", 2, 0),
    ], export="f")
    return b.build()


def test_per_tenant_wasi_isolation(tmp_path):
    """Each tenant is served through its own WASI environ: two tenants
    with disjoint preopened directories see their own files, and a third
    with B's environ does not see A's file; the JAX package agrees."""
    dir_a, dir_b = tmp_path / "a", tmp_path / "b"
    dir_a.mkdir()
    dir_b.mkdir()
    (dir_a / "s").write_bytes(b"AAAA")
    (dir_b / "s").write_bytes(b"BBBB")
    (dir_a / "t").write_bytes(b"ONLY")   # exists only for tenant A
    L = 8

    def specs(pkg, conf):
        out = []
        for byte, d in ((ord("s"), dir_a), (ord("s"), dir_b),
                        (ord("t"), dir_b)):
            wasi = (WasiModule if pkg == "port" else RefWasiModule)()
            wasi.init_wasi(dirs=[f"/:{d}"])
            inst, store = inst_of(pkg, _reader(byte), conf, [wasi])
            out.append((inst, store, "f", [np.zeros(L, np.int64)], L))
        return out

    conf = _conf("port")
    conf.batch.steps_per_launch = 10_000
    got = run_mixed(specs("port", conf), conf=conf, max_steps=200_000,
                    device="cpu")
    rconf = _conf("ref")
    rconf.batch.steps_per_launch = 10_000
    want = ref_run_mixed(specs("ref", rconf), conf=rconf, max_steps=200_000)
    _assert_results_equal(got, want, "wasi")
    word = {k: int.from_bytes(v, "little")
            for k, v in (("a", b"AAAA"), ("b", b"BBBB"))}
    assert (got[0].results[0] == word["a"]).all()
    assert (got[1].results[0] == word["b"]).all()
    # tenant C shares B's preopen root: file "t" is not there (-NOENT)
    c = np.asarray(got[2].results[0], np.int64).astype(np.uint32) \
        .view(np.int32)
    assert (c == -44).all(), c


@pytest.mark.parametrize("case", ["three_modules", "config5", "clash"])
def test_blocks_plan_of_a_concatenated_image(case):
    """B2 over the concatenated image: its blocks are each tenant's own
    plan shifted by the tenant's pc base, and none crosses a tenant
    boundary."""
    tenants = tenants_of("port", CASES[case], _conf("port"))
    mt = MultiTenantBatchEngine(tenants, conf=_conf("port"), device="cpu")
    hid, shapes = fuse_blocks(hid_plane(mt.img), mt.img)
    for t, base in zip(tenants, mt.bases):
        own, own_shapes = fuse_blocks(hid_plane(t.img), t.img)
        seg = hid[base["pc"]:base["pc"] + t.img.code_len]
        got = [(pc, shapes[h - H_BLOCK_BASE])
               for pc, h in enumerate(seg) if h >= H_BLOCK_BASE]
        want = [(pc, own_shapes[h - H_BLOCK_BASE])
                for pc, h in enumerate(own) if h >= H_BLOCK_BASE]
        assert got == want and got
        # every block ends inside its tenant
        assert all(pc + len(shape) <= t.img.code_len for pc, shape in got)


def _c10_tenants(pkg, conf, lanes=4):
    d = np.array([1, 2, 3, 0], np.int64)
    return [(*inst_of(pkg, build_grow_tenant(m), conf), "g", [d], lanes)
            for m in C10_MAX_PAGES]


def test_c10_each_tenant_keeps_its_own_ceiling():
    """ROADMAP C10: A declares memory (1, max 1), B (1, max 4), with four
    pages a lane.  The port's mixed run gives A [-1, -1, -1, 1], as A's
    solo run, the JAX Pallas route and the scalar engine do; the JAX SIMT
    path lets A grow to B's ceiling ([1, 1, 1, 1])."""
    conf = _conf("port", C10_PAGES_PER_LANE)
    got = run_mixed(_c10_tenants("port", conf), conf=conf, device="cpu")
    a_want, b_want = [-1, -1, -1, 1], [1, 1, 1, 1]
    assert got[0].results[0].tolist() == u32_cells(a_want).tolist()
    assert got[1].results[0].tolist() == u32_cells(b_want).tolist()
    # each tenant alone on the port
    for (inst, store, func, args, lanes), r in zip(
            _c10_tenants("port", conf), got):
        solo = BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                           device="cpu").run(func, args)
        np.testing.assert_array_equal(solo.results[0], r.results[0])
    # the scalar engine, one call a lane
    for m, r in zip(C10_MAX_PAGES, got):
        for k, d in enumerate((1, 2, 3, 0)):
            vm = VM(conf)
            vm.load_wasm(build_grow_tenant(m)).validate().instantiate()
            assert vm.execute("g", [d])[0] & 0xFFFFFFFF == r.results[0][k]
    # the JAX Pallas route: one engine a tenant, each with its ceiling
    pconf = RefConfigure()
    pconf.batch.memory_pages_per_lane = C10_PAGES_PER_LANE
    pconf.batch.interpret = True
    pconf.batch.use_pallas = True
    tenants = [RefTenant(RefEngine(i, store=s, conf=pconf, lanes=8), f,
                         [np.tile(a[0], 2)], 8)
               for i, s, f, a, _ in _c10_tenants("ref", pconf)]
    mt = RefMultiTenant(tenants, conf=pconf)
    pallas = mt.run_tenants(max_steps=10_000)
    assert mt.used_pallas
    for p, r in zip(pallas, got):
        assert (np.asarray(p.results[0], np.int64)[:4] & 0xFFFFFFFF
                ).tolist() == r.results[0].tolist()
    # the JAX SIMT path differs: A grows past its declared maximum
    rconf = _conf("ref", C10_PAGES_PER_LANE)
    simt = ref_run_mixed(_c10_tenants("ref", rconf), conf=rconf)
    assert (np.asarray(simt[0].results[0], np.int64) & 0xFFFFFFFF
            ).tolist() == u32_cells([1, 1, 1, 1]).tolist()
    assert (np.asarray(simt[1].results[0], np.int64) & 0xFFFFFFFF
            ).tolist() == got[1].results[0].tolist()


def test_c10_image_holds_each_tenants_ceiling():
    """The concatenated image equals the JAX one but for the `b` of the
    two memory.grow words: 1 and 4, where the JAX image reads its one
    mem_pages_max, 4."""
    conf = _conf("port", C10_PAGES_PER_LANE)
    port = [Tenant(BatchEngine(i, store=s, conf=conf, lanes=n,
                               device="cpu"), f, a, n)
            for i, s, f, a, n in _c10_tenants("port", conf)]
    rconf = _conf("ref", C10_PAGES_PER_LANE)
    ref = [RefTenant(RefEngine(i, store=s, conf=rconf, lanes=n), f, a, n)
           for i, s, f, a, n in _c10_tenants("ref", rconf)]
    img, _ = concat_images(port)
    rimg, _ = ref_concat(ref)
    assert_image_equals_jax(img, rimg, memgrow_b=list(C10_MAX_PAGES))
    assert img.mem_pages_max == rimg.mem_pages_max == 4


def test_host_grow_keeps_the_owning_tenants_ceiling():
    """A host function that grows memory, called from two tenants with
    ceilings 1 and 4: each grow keeps to its own tenant's ceiling."""
    def host():
        imp = ImportObject("env")
        imp.add_func("grow", PyHostFunction(lambda mem, d: mem.grow(d),
                                            ["i32"], ["i32"]))
        return imp

    def module(m):
        b = ModuleBuilder()
        b.import_func("env", "grow", ["i32"], ["i32"])
        b.add_memory(1, m)
        b.add_function(["i32"], ["i32"], [],
                       [("local.get", 0), ("call", 0)], export="h")
        return b.build()

    conf = _conf("port", C10_PAGES_PER_LANE)
    d = np.array([1, 3, 0], np.int64)
    specs = [(*inst_of("port", module(m), conf, [host()]), "h", [d], 3)
             for m in C10_MAX_PAGES]
    got = run_mixed(specs, conf=conf, device="cpu")
    solo = [BatchEngine(i, store=s, conf=conf, lanes=n, device="cpu")
            .run(f, a) for i, s, f, a, n in specs]
    for g, s in zip(got, solo):
        np.testing.assert_array_equal(g.results[0], s.results[0])
    assert got[0].results[0].tolist() != got[1].results[0].tolist()
