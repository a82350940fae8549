"""The port's image store on the CPU, held against the JAX package's
(wasmedge_tpu/imagestore/): a segmented registration lowers each module
once and builds one new segment a generation; the segmented image equals
the inline one and the JAX package's concatenation of the same modules,
field by field; a module's pre-initialized snapshot gives the results of
template init, and its overlay the JAX capture's columns; a faulted or
corrupt snapshot install falls back to template init; every knob off
leaves the store inert; the swap store round-trips and refuses rot."""

import numpy as np
import pytest

from tests.test_torch_multitenant import assert_image_equals_jax, inst_of
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.gateway.registry import ModuleRegistry as RefRegistry
from wasmedge_tpu.hv.swapstore import SwapStore as RefSwapStore
from wasmedge_tpu.hv.swapstore import (
    deserialize_columns as ref_deserialize_columns,
    serialize_columns as ref_serialize_columns)
from wasmedge_tpu.imagestore import capture_snapshot as ref_capture
from wasmedge_tpu.imagestore import decode_overlay as ref_decode
from wasmedge_tpu_torch.batch.image import DeviceImage
from wasmedge_tpu_torch.batch.multitenant import MultiModuleBatchEngine
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.gateway import GatewayService
from wasmedge_tpu_torch.gateway.registry import ModuleRegistry
from wasmedge_tpu_torch.hv.swapstore import (
    SwapCorrupt, SwapStore, deserialize_columns, serialize_columns)
from wasmedge_tpu_torch.imagestore import (
    SegmentCache, capture_snapshot, decode_overlay, init_export_of)
from wasmedge_tpu_torch.models import build_fib
from wasmedge_tpu_torch.testing.faults import Fault, FaultInjector
from wasmedge_tpu_torch.utils.builder import ModuleBuilder


def _conf(segmented=False, snapshots=False):
    conf = Configure()
    conf.batch.steps_per_launch = 256
    conf.batch.value_stack_depth = 128
    conf.batch.call_stack_depth = 64
    conf.imagestore.segmented = segmented
    conf.imagestore.snapshots = snapshots
    return conf


def _ref_conf():
    conf = RefConfigure()
    conf.batch.steps_per_launch = 256
    conf.batch.value_stack_depth = 128
    conf.batch.call_stack_depth = 64
    conf.batch.use_pallas = False
    conf.batch.fuse_superinstructions = False
    conf.batch.tierup = False
    return conf


def build_affine(mul: int, add: int) -> bytes:
    b = ModuleBuilder()
    b.add_function(["i64"], ["i64"], [],
                   [("local.get", 0), ("i64.const", mul), "i64.mul",
                    ("i64.const", add), "i64.add"], export="f")
    return b.build()


def build_lazyinit() -> bytes:
    """A nontrivial `_initialize` (a mutable global, a memory word, an
    init flag) that `compute` runs lazily: template init runs it inside
    the first call, a snapshot has it done already; the results agree."""
    b = ModuleBuilder()
    b.add_memory(1)
    b.add_global("i32", True, [("i32.const", 0)])   # init flag
    b.add_global("i64", True, [("i64.const", 0)])   # g
    b.add_function([], [], [],
                   [("i32.const", 1), ("global.set", 0),
                    ("i64.const", 7), ("global.set", 1),
                    ("i32.const", 0), ("i64.const", 42),
                    ("i64.store", 3, 0)], export="_initialize")
    b.add_function(["i64"], ["i64"], [],
                   [("global.get", 0), "i32.eqz",
                    ("if", None), ("call", 0), "end",
                    ("local.get", 0), ("global.get", 1), "i64.add",
                    ("i32.const", 0), ("i64.load", 3, 0), "i64.add"],
                   export="compute")
    return b.build()


def build_trapping_init() -> bytes:
    """An `_initialize` that traps: no snapshot, template init."""
    b = ModuleBuilder()
    b.add_function([], [], [], ["unreachable"], export="_initialize")
    b.add_function(["i64"], ["i64"], [], [("local.get", 0)], export="id")
    return b.build()


def _invoke(svc, func, args, module=None):
    req = svc.submit(func, args, module=module)
    assert svc.wait(req, timeout_s=120.0)
    return req.future.result(0)


DATAS = [("m0", build_affine(3, 1)), ("m1", build_fib()),
         ("m2", build_lazyinit())]


def test_segmented_registration_builds_one_segment_a_generation():
    svc = GatewayService(conf=_conf(segmented=True), lanes=2, device="cpu")
    try:
        mods = [(f"m{k}", build_affine(2 + k, 7 * (k + 1)))
                for k in range(3)]
        for name, data in mods:
            svc.register_module(name, wasm_bytes=data)
        # three generations, each module lowered once and its segment
        # built once: gen 1 builds m0; gen 2 reuses m0 and builds m1; gen 3
        # reuses both and builds m2
        assert svc.registry.lowered_count == 3
        assert svc.registry.segment_cache.stats() == {
            "entries": 3, "hits": 3, "builds": 3}
        for k, (name, _) in enumerate(mods):
            assert _invoke(svc, "f", [10], module=name) == \
                [10 * (2 + k) + 7 * (k + 1)]
        cs = svc.status()["coldstart"]
        assert cs["lowered_count"] == 3 and cs["segments"]["builds"] == 3
        assert cs["compile_cache"]["enabled"] is False
    finally:
        svc.shutdown()


def _images_equal(a, b):
    for f in DeviceImage.NUMPY_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    for f in DeviceImage.SCALAR_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def test_segmented_image_equals_inline_and_jax():
    engines = []
    for seg in (False, True):
        conf = _conf()
        reg = ModuleRegistry(conf=conf, device="cpu")
        if seg:
            reg.segment_cache = SegmentCache()
        for name, data in DATAS:
            reg.add_wasm(name, data)
        first = reg.build_engine(conf, 2)
        engines.append(reg.build_engine(conf, 2))
        # the generation reused the registry's one-lane engines
        assert [t.engine for t in engines[-1].tenants] == \
            [reg.get(n).engine for n, _ in DATAS]
        assert [t.engine for t in first.tenants] == \
            [t.engine for t in engines[-1].tenants]
        assert reg.lowered_count == 3
        if seg:
            assert reg.segment_cache.stats()["builds"] == 3
            assert reg.segment_cache.stats()["hits"] == 3
        reg.close()
    a, b = engines
    _images_equal(a.img, b.img)
    assert a.bases == b.bases
    # and the monolithic build, which lowers every module itself
    conf = _conf()
    mono = MultiModuleBatchEngine(
        [(name, *inst_of("port", data, conf)) for name, data in DATAS],
        conf=conf, lanes=2, device="cpu")
    _images_equal(mono.img, b.img)
    assert mono.bases == b.bases
    rconf = _ref_conf()
    rreg = RefRegistry(conf=rconf)
    for name, data in DATAS:
        rreg.add_wasm(name, data)
    ref = rreg.build_engine(rconf, 2)
    assert_image_equals_jax(b.img, ref.img, memgrow_b=np.zeros(0, np.int32))
    assert b.bases == [{k: v for k, v in base.items() if k in b.bases[0]}
                       for base in ref.bases]
    rreg.close()


def test_snapshot_results_equal_template_init():
    want = [int(i) + 7 + 42 for i in (0, 5, 100)]
    got = {}
    for snap in (False, True):
        svc = GatewayService(conf=_conf(snapshots=snap), lanes=2,
                             device="cpu")
        try:
            svc.register_module("lazy", wasm_bytes=build_lazyinit())
            got[snap] = [_invoke(svc, "compute", [i], module="lazy")[0]
                         for i in (0, 5, 100)]
            if snap:
                assert svc.snapshot_counts.get("captured") == 1
                assert svc.snapshot_counts.get("installs", 0) >= 3
                assert svc.registry.get("lazy").snapshot is not None
            else:
                assert svc.snapshot_store is None
        finally:
            svc.shutdown()
    assert got[False] == got[True] == want


def test_snapshot_overlay_equals_jax_capture():
    """The port's captured columns against the JAX package's capture of the
    same module on its one-lane engine: the globals equal, the memory rows
    the JAX capture keeps equal, the port's rows past them equal the
    template's (untouched by init)."""
    conf = _conf()
    reg = ModuleRegistry(conf=conf, device="cpu")
    rm = reg.add_wasm("lazy", build_lazyinit())
    assert init_export_of(rm) == "_initialize"
    counts = {}
    store = SwapStore()
    rm.snapshot = capture_snapshot(rm, store, counts)
    ov = decode_overlay(rm, store, counts=counts)
    rreg = RefRegistry(conf=_ref_conf())
    rrm = rreg.add_wasm("lazy", build_lazyinit())
    rcounts = {}
    rstore = RefSwapStore()
    rrm.snapshot = ref_capture(rrm, rstore, rcounts)
    rov = ref_decode(rrm, rstore, counts=rcounts)
    assert counts == rcounts == {"captured": 1}
    assert rm.snapshot.meta == rrm.snapshot.meta
    for k in ("glob_lo", "glob_hi"):
        np.testing.assert_array_equal(ov[k], rov[k], err_msg=k)
    assert ov["mem_pages"] == rov["mem_pages"] == 1
    n = rov["mem"].shape[0]
    np.testing.assert_array_equal(ov["mem"][:n], rov["mem"])
    tail = ov["mem"][n:]
    init = rm.engine.img.mem_init
    np.testing.assert_array_equal(
        tail, np.pad(init, (0, max(0, ov["mem"].shape[0] - init.shape[0])))
        [n:ov["mem"].shape[0]])
    assert ov["mem"][:2].tolist() == [42, 0]
    reg.close()
    rreg.close()


@pytest.mark.parametrize("mode", ["install_fault", "corrupt"])
def test_snapshot_install_failure_falls_back_to_template(mode):
    faults = FaultInjector([Fault(point="snapshot_install", at=0)]) \
        if mode == "install_fault" else None
    svc = GatewayService(conf=_conf(snapshots=True), lanes=2,
                         device="cpu", faults=faults)
    if mode == "corrupt":
        put = svc.snapshot_store.put

        def rotting_put(payload):
            key = put(payload)
            svc.snapshot_store._mem[key] = payload[:-1] + bytes(
                [payload[-1] ^ 1])
            return key

        svc.snapshot_store.put = rotting_put
    try:
        svc.register_module("lazy", wasm_bytes=build_lazyinit())
        assert _invoke(svc, "compute", [5], module="lazy") == [54]
        counts = svc.snapshot_counts
        key = "install_faults" if mode == "install_fault" else "corrupt"
        assert counts.get(key, 0) >= 1
        assert counts.get("installs", 0) == 0
    finally:
        svc.shutdown()


def test_snapshot_skipped_without_a_clean_init():
    svc = GatewayService(conf=_conf(snapshots=True), lanes=2, device="cpu")
    try:
        svc.preload([("trap", build_trapping_init()), ("fib", build_fib())])
        assert svc.snapshot_counts == {"skipped": 1}
        assert svc.registry.get("trap").snapshot is None
        assert _invoke(svc, "id", [5], module="trap") == [5]
        assert _invoke(svc, "fib", [7], module="fib") == [13]
    finally:
        svc.shutdown()


@pytest.mark.parametrize("failure", ["build", "launch", "store"])
def test_snapshot_capture_runtime_failure(monkeypatch, failure):
    """The init run is the guest's to fail, not the runtime's: a kernel
    that does not build or a launch that fails during it rolls the
    registration back as a retryable GenerationBuildFailed, the prior
    generation serving and the re-POST lowering nothing; a failed store
    write only skips the snapshot (template init)."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.batch.engine import BatchEngine
    from wasmedge_tpu_torch.gateway import GenerationBuildFailed

    err = {"build": interp.KernelBuildError("nvcc failed"),
           "launch": RuntimeError("interpreter kernel launch failed: CUDA "
                                  "error 700"),
           "store": OSError(28, "No space left on device")}[failure]

    def raising(*a, **k):
        raise err

    svc = GatewayService(conf=_conf(snapshots=True), lanes=2, device="cpu")
    try:
        svc.register_module("fib", wasm_bytes=build_fib())
        if failure == "store":
            monkeypatch.setattr(svc.snapshot_store, "put", raising)
            svc.register_module("lazy", wasm_bytes=build_lazyinit())
            assert svc.snapshot_counts == {"skipped": 1}
            assert svc.registry.get("lazy").snapshot is None
        else:
            monkeypatch.setattr(BatchEngine, "run_from_state", raising)
            with pytest.raises(GenerationBuildFailed) as e:
                svc.register_module("lazy", wasm_bytes=build_lazyinit())
            assert e.value.retryable and e.value.__cause__ is err
            assert svc.generation == 1 and svc.registry.names == ["fib"]
            assert svc.counters["rollbacks"] == 1
            assert svc.snapshot_counts == {}
            monkeypatch.undo()
            lowered = svc.registry.lowered_count
            svc.register_module("lazy", wasm_bytes=build_lazyinit())
            assert svc.registry.lowered_count == lowered
            assert svc.snapshot_counts["captured"] == 1
        assert _invoke(svc, "compute", [5], module="lazy") == [54]
        assert _invoke(svc, "fib", [7], module="fib") == [13]
    finally:
        svc.shutdown()


def test_knobs_off_leave_the_store_inert():
    svc = GatewayService(conf=_conf(), lanes=2, device="cpu")
    try:
        svc.register_module("fib", wasm_bytes=build_fib())
        assert svc.imagestore_enabled is False
        assert svc.registry.segment_cache is None
        assert svc.registry.compile_cache.enabled is False
        assert svc.snapshot_store is None
        assert "coldstart" not in svc.status()
        assert _invoke(svc, "fib", [9], module="fib") == [34]
    finally:
        svc.shutdown()
    with pytest.raises(NotImplementedError, match="A7.7"):
        svc.registry.compile_cache.enable("/nonexistent")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_swap_store_and_columns_equal_jax(tmp_path, writer):
    cols = {"mem": np.arange(9, dtype=np.int32),
            "glob_lo": np.array([1, -2], np.int32)}
    ser = serialize_columns if writer == "port" else ref_serialize_columns
    payload = ser(cols, {"mem_pages": 1})
    for des in (deserialize_columns, ref_deserialize_columns):
        got, meta = des(payload)
        assert meta == {"mem_pages": 1, "planes": ["glob_lo", "mem"]}
        for k in cols:
            np.testing.assert_array_equal(got[k], cols[k])
    store = SwapStore(dir=str(tmp_path / "port"))
    ref = RefSwapStore(dir=str(tmp_path / "ref"))
    assert store.put(payload) == ref.put(payload)
    key = store.put(payload)
    assert store.get(key) == payload and len(store) == 1
    store.release(key)
    assert store.get(key) == payload   # one owner left
    store.release(key)
    with pytest.raises(SwapCorrupt):
        store.get(key)
    key = store.put(payload)
    store._mem[key] = payload[:-1]
    with pytest.raises(SwapCorrupt, match="hash mismatch"):
        store.get(key)
