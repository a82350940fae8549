"""The port's fusion planners against the reference's.

`wasmedge_tpu_torch.batch.fusion.fuse_blocks` (B2 basic blocks) and
`fuse_image` (B6 superinstructions) must give the same rewritten handler
ids, block shapes and operand planes as `wasmedge_tpu.batch.pallas_engine`'s
functions of the same names, on the same image (the reference's image,
carried into the port with `batch.convert`), for every fixture of the
slice; and the port's planners and the CUDA source generated from their
output must be deterministic.
"""

import numpy as np
import pytest

from wasmedge_tpu.batch import pallas_engine as P
from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu_torch.batch import fusegen, fusion
from wasmedge_tpu_torch.batch.interp import (
    H_FUSE_GCA_BASE, device_tables, hid_plane)
from wasmedge_tpu_torch.models import (
    build_bulk_workload, build_coremark_kernel, build_echo, build_fac,
    build_fib, build_loop_sum, build_memory_workload, build_simd_loop)
from wasmedge_tpu_torch.models.fixtures import (
    build_guard_mix, build_host_double, build_many_shapes, build_oob_mix,
    build_simd_sweep, build_straight_line, build_trap_zoo, build_vmix,
    simd_sweeps)
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_hostcall import _env_import, _wasi
from tests.test_torch_interp import _image_of


def _sweep(i):
    return lambda: build_simd_sweep(list(simd_sweeps().values())[i])


# name -> (module, imports of the reference instance)
MODULES = {
    "fib": (build_fib, None),
    "fac": (build_fac, None),
    "loop_sum": (build_loop_sum, None),
    "mem_checksum": (build_memory_workload, None),
    "coremark": (build_coremark_kernel, None),
    "trap_zoo": (build_trap_zoo, None),
    "echo": (build_echo, "wasi"),
    "host_double": (build_host_double, "env"),
    "bulk": (build_bulk_workload, None),
    "vmix": (build_vmix, None),
    "vloop": (build_simd_loop, None),
    "sweep_0": (_sweep(0), None),
    "sweep_4": (_sweep(4), None),
    "guard_mix": (build_guard_mix, None),
    "oob_mix": (build_oob_mix, None),
    "straight_line": (build_straight_line, None),
    "many_shapes": (build_many_shapes, None),
}


def _ref_image(name):
    build, imports = MODULES[name]
    conf = RefConfigure()
    b = conf.batch
    b.value_stack_depth, b.call_stack_depth = 64, 16
    b.memory_pages_per_lane = 1
    imps = None
    if imports == "env":
        imps = [_env_import("ref")]
    elif imports == "wasi":
        imps = [_wasi("ref", 1)]
    _, store, inst = ref_instantiate(build(), conf, imports=imps)
    return RefEngine(inst, store=store, conf=conf, lanes=2).img


@pytest.mark.parametrize("name", list(MODULES))
def test_fuse_blocks_matches_reference(name):
    ref_img = _ref_image(name)
    img = _image_of(ref_img)
    hid = hid_plane(img)
    np.testing.assert_array_equal(hid, P.hid_plane(ref_img))
    got_hid, got_shapes = fusion.fuse_blocks(hid, img)
    want_hid, want_shapes = P.fuse_blocks(P.hid_plane(ref_img), ref_img)
    np.testing.assert_array_equal(got_hid, want_hid)
    assert got_shapes == want_shapes
    assert (got_hid >= fusion.H_BLOCK_BASE).any()
    # absorbed slots keep their ids; only head slots change
    heads = got_hid != hid
    assert (got_hid[heads] >= fusion.H_BLOCK_BASE).all()
    flen = fusion.fused_lengths(got_hid, got_shapes)
    assert ((flen > 0) == heads).all()
    assert flen.max() <= fusion.MAX_BLOCK_LEN
    if name == "straight_line":
        # a run of pure ops is cut at MAX_BLOCK_LEN - 1 ops (the last
        # slot is for a terminal)
        assert (flen == fusion.MAX_BLOCK_LEN - 1).sum() >= 2
    if name == "many_shapes":
        assert len(got_shapes) == fusion.MAX_BLOCK_SHAPES
        # shapes past the 96th stay unfused
        assert (flen == 0).sum() > (hid == hid).sum() // 2


@pytest.mark.parametrize("name", list(MODULES))
def test_fuse_image_matches_reference(name):
    ref_img = _ref_image(name)
    img = _image_of(ref_img)
    hid = hid_plane(img)
    got = fusion.fuse_image(hid, img.a, img.b, img.c, img.imm_lo, img.imm_hi,
                            img)
    want = P.fuse_image(P.hid_plane(ref_img), ref_img.a, ref_img.b,
                        ref_img.c, ref_img.imm_lo, ref_img.imm_hi, ref_img)
    for plane, g, w in zip(("hid", "a", "b", "c", "ilo", "ihi"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=plane)
    # the input planes are not modified
    np.testing.assert_array_equal(hid, hid_plane(img))


@pytest.mark.parametrize("name", ["fib", "coremark", "vloop", "guard_mix"])
def test_planners_and_generated_source_are_deterministic(name):
    img = _image_of(_ref_image(name))
    for enc in ("blocks", "super"):
        if enc == "super" and img.has_simd:
            with pytest.raises(ValueError):
                device_tables(img, "cpu", enc)
            continue
        t1 = device_tables(img, "cpu", enc)
        t2 = device_tables(img, "cpu", enc)
        assert t1.fused_source == t2.fused_source
        assert t1.shapes == t2.shapes
        # one case per block head (all of them under the instance cap)
        # and per superinstruction id present
        ids = set(t1.hid.tolist())
        n_super = sum(1 for h in ids if fusion.super_family(h))
        n_heads = int((t1.hid >= fusion.H_BLOCK_BASE).sum())
        assert n_heads <= fusegen.MAX_INSTANCE_CASES
        assert t1.fused_source.count("      case ") == n_heads + n_super
        assert "WASM_FUSED_LAUNCH(" in t1.fused_source
    assert device_tables(img, "cpu").fused_source == ""


def test_super_family_ids():
    for base, n in fusion.SUPER_LEN.items():
        assert fusion.super_family(base + 3) == (base, 3)
    assert fusion.super_family(P.H_FUSE_GBR) == (P.H_FUSE_GBR, None)
    assert fusion.super_family(H_FUSE_GCA_BASE - 1) is None
    assert fusion.super_family(P.H_LOAD_W) is None
    src = fusegen.cuda_source(np.array([P.H_FUSE_GGBNZ_BASE + 17]), (),
                              False, False)
    assert "GGBNZ alu2:17" in src
