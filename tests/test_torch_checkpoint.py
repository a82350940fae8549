"""Checkpoints of in-flight batches (batch/checkpoint.py) on the port.

The JAX package's tests/test_checkpoint.py on the port's engine: a run
interrupted at a launch boundary, saved, loaded into a fresh engine and
finished equals the uninterrupted run; a snapshot of another image, lane
count or geometry is refused; a save that fails leaves the earlier
snapshot and its digest sidecar as they were; corrupt control planes are
refused.  With lane compaction (tests/test_compact.py:347): the mapping
rides the snapshot as `lane_src` and a compacted run resumed from it
finishes with the uncompacted run's results; an engine with compaction
off, or managed outside it, refuses it.  Against the JAX package: for one
state carried across (batch/convert.py) after the same permutation, both
packages' `save` write the same `state_*` arrays, the same `lane_src`
and the same `meta`; `image_sha256` is equal where the images are equal
field by field, and differs on an image with memory.grow, whose `b` is
the grow's page ceiling in the port (ROADMAP C10).
"""

import hashlib
import io
import os

import numpy as np
import pytest

from wasmedge_tpu.batch import checkpoint as ref_checkpoint
from wasmedge_tpu.batch.compact import arm as ref_arm
from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu_torch.batch.checkpoint import (
    image_fingerprint, load, read_extra_arrays, read_meta, save)
from wasmedge_tpu_torch.batch.compact import arm
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.image import CLS_MEMGROW
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.models import build_fib, build_memory_workload
from wasmedge_tpu_torch.models.fixtures import (
    build_trap_zoo, compact_conf, div_args, fib_model)
from tests.test_torch_interp import _ref_planes
from tests.test_torch_multitenant import inst_of


def make(data, lanes=16, compact=False, **knobs):
    conf = Configure()
    conf.batch.steps_per_launch = 100
    if compact:
        compact_conf(conf, steps_per_launch=48, value_stack_depth=128,
                     call_stack_depth=64)
    for k, v in knobs.items():
        setattr(conf.batch, k, v)
    inst, store = inst_of("port", data, conf)
    return BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                       device="cpu")


def start(eng, func, args):
    return eng.initial_state(eng.export_func_idx(func), args)


def test_interrupt_resume_bitmatch(tmp_path):
    args = [(np.arange(16) % 13).astype(np.int64)]
    ref_eng = make(build_fib())
    ref_state, ref_total = ref_eng.run_from_state(
        start(ref_eng, "fib", args), 0, 500_000)
    eng = make(build_fib())
    state, total = eng.run_from_state(start(eng, "fib", args), 0, 700)
    assert (state.trap == 0).any()   # in flight
    ckpt = tmp_path / "batch.ckpt"
    save(ckpt, eng, state, total, invocation={"func": "fib"})
    assert read_meta(ckpt)["invocation"] == {"func": "fib"}
    eng2 = make(build_fib())
    state2, total2 = load(ckpt, eng2)
    assert total2 == total and state2.pc.device.type == "cpu"
    state2, total2 = eng2.run_from_state(state2, total2, 500_000)
    for name in ("trap", "retired", "stack_lo", "stack_hi", "mem"):
        assert np.array_equal(getattr(ref_state, name).numpy(),
                              getattr(state2, name).numpy()), name
    assert total2 == ref_total


def test_checkpoint_refuses_wrong_image(tmp_path):
    eng = make(build_fib())
    state, total = eng.run_from_state(
        start(eng, "fib", [np.full(16, 9, np.int64)]), 0, 300)
    ckpt = tmp_path / "c.ckpt"
    save(ckpt, eng, state, total)
    with pytest.raises(ValueError, match="different module image"):
        load(ckpt, make(build_memory_workload()))
    with pytest.raises(ValueError, match="lanes"):
        load(ckpt, make(build_fib(), lanes=8))
    with pytest.raises(ValueError, match="geometry"):
        load(ckpt, make(build_fib(), value_stack_depth=128))


def test_checkpoint_save_is_atomic(tmp_path, monkeypatch):
    eng = make(build_fib())
    state, total = eng.run_from_state(
        start(eng, "fib", [np.full(16, 9, np.int64)]), 0, 300)
    ckpt = tmp_path / "c.ckpt"
    save(ckpt, eng, state, total, extra_arrays={"blob_a": np.arange(3)})
    good = ckpt.read_bytes()
    state2, total2 = eng.run_from_state(state, total, 600)
    real_replace = os.replace

    def boom(src, dst):
        raise OSError("simulated crash mid-save")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError, match="simulated crash"):
        save(ckpt, eng, state2, total2)
    monkeypatch.setattr(os, "replace", real_replace)
    assert ckpt.read_bytes() == good
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["c.ckpt", "c.ckpt.sha256"]
    assert (tmp_path / "c.ckpt.sha256").read_bytes().decode() == \
        hashlib.sha256(good).hexdigest()
    _, rtotal = load(ckpt, make(build_fib()))
    assert rtotal == total
    assert read_extra_arrays(ckpt, "blob_")["blob_a"].tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="collides"):
        save(tmp_path / "x.ckpt", eng, state, total,
             extra_arrays={"state_pc": np.zeros(1)})
    # no tier-0 stdout buffer: a stdout position has nothing to journal
    save(tmp_path / "x.ckpt", eng, state, total, stdout_pos=[0])
    with np.load(tmp_path / "x.ckpt", allow_pickle=False) as z:
        assert "stdout_pos" not in z.files


def test_checkpoint_refuses_corrupt_control_planes(tmp_path):
    eng = make(build_fib())
    state, total = eng.run_from_state(
        start(eng, "fib", [np.full(16, 9, np.int64)]), 0, 300)
    ckpt = tmp_path / "c.ckpt"
    save(ckpt, eng, state, total)

    def tamper(plane, vals):
        with np.load(ckpt, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files if k != "meta"}
            meta = str(z["meta"])
        bad = arrays[f"state_{plane}"].copy()
        bad[..., 0] = vals
        arrays[f"state_{plane}"] = bad
        buf = io.BytesIO()
        np.savez_compressed(buf, meta=meta, **arrays)
        p = tmp_path / f"bad_{plane}.ckpt"
        p.write_bytes(buf.getvalue())
        return p

    for plane, vals in (("pc", -1), ("pc", 10 ** 6), ("fp", -3),
                        ("sp", 10 ** 6), ("call_depth", -1),
                        ("mem_pages", 10 ** 6), ("trap", -77)):
        with pytest.raises(ValueError, match="refused"):
            load(tamper(plane, vals), make(build_fib()))


def test_checkpoint_lane_src_roundtrip_and_refusal(tmp_path):
    eng = make(build_fib(), compact=True)
    arm(eng)
    ns = div_args(16)
    state, total = eng.run_from_state(start(eng, "fib", [ns]), 0, 96)
    assert eng.compactor.stats["fires"] >= 1
    assert not eng.compactor.identity
    src = eng.compactor.src.copy()
    path = tmp_path / "ckpt.npz"
    save(path, eng, state, total)
    eng2 = make(build_fib(), compact=True)
    arm(eng2)
    st2, tot2 = load(path, eng2)
    assert (eng2.compactor.src == src).all()
    assert eng2.compactor.width == 16   # narrowing fires again
    st2, tot2 = eng2.run_from_state(st2, tot2, 500_000)
    order = eng2.compactor.restore_order()
    got = st2.stack_lo[0].numpy()[order]
    np.testing.assert_array_equal(got, fib_model(ns).astype(np.int32))
    eng3 = make(build_fib(), compact=True)
    eng3.cfg.compact = False
    with pytest.raises(ValueError, match="lane compaction"):
        load(path, eng3)
    eng4 = make(build_fib(), compact=True)
    eng4._compact_external = True
    with pytest.raises(ValueError, match="lane compaction"):
        load(path, eng4)


def _pair(data, func, args, tmp_path, compact=True):
    """One JAX state, call by call up to the first permutation, carried
    into the port's engine with the same mapping; both packages'
    files."""
    rconf = RefConfigure()
    if compact:
        compact_conf(rconf, steps_per_launch=48, value_stack_depth=128,
                     call_stack_depth=64)
    rconf.batch.fuse_superinstructions = False
    rconf.batch.tierup = False
    rinst, rstore = inst_of("ref", data, rconf)
    ref = RefEngine(rinst, store=rstore, conf=rconf, lanes=16)
    ref_arm(ref)
    st, total = ref.initial_state(ref.export_func_idx(func), args), 0
    while ref.compactor.identity and total < 10_000:
        st, total = ref.run_from_state(st, total, total + 1)
    ref_checkpoint.save(tmp_path / "ref.npz", ref, st, total)
    eng = make(data, compact=compact)
    comp = arm(eng)
    if compact:
        assert not ref.compactor.identity
        comp.src = ref.compactor.src.copy()
    save(tmp_path / "port.npz", eng, state_from_reference(
        _ref_planes(st), device="cpu"), total)
    out = []
    for name in ("ref", "port"):
        with np.load(tmp_path / f"{name}.npz", allow_pickle=False) as z:
            out.append({k: np.asarray(z[k]) for k in z.files})
    return out, ref, eng


@pytest.mark.parametrize("case", ["fib", "mem_checksum", "trap_zoo"])
def test_checkpoint_files_equal_jax(case, tmp_path):
    data, func, args = {
        "fib": (build_fib(), "fib", [div_args(16)]),
        "mem_checksum": (build_memory_workload(), "mem_checksum",
                         [np.arange(16, dtype=np.int64) % 5 * 3]),
        "trap_zoo": (build_trap_zoo(), "zoo",
                     [np.arange(16, dtype=np.int64) % 9]),
    }[case]
    (ref, port), ref_eng, eng = _pair(data, func, args, tmp_path)
    planes = {k for k in port if k.startswith("state_")}
    assert planes and planes <= set(ref)
    for k in planes:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(port["lane_src"], ref["lane_src"])
    pm, rm = (eval_meta(x) for x in (port, ref))
    assert {k: v for k, v in pm.items() if k != "image_sha256"} == \
        {k: v for k, v in rm.items() if k != "image_sha256"}
    grows = bool((eng.img.cls == CLS_MEMGROW).any())
    assert grows == (case == "trap_zoo")
    # equal images field by field, equal hashes; memory.grow's `b` is
    # the port's page ceiling (C10), so such images differ
    assert (pm["image_sha256"] == rm["image_sha256"]) == (not grows)
    assert pm["image_sha256"] == image_fingerprint(eng.img)


def eval_meta(arrays):
    import json

    return json.loads(str(arrays["meta"]))
