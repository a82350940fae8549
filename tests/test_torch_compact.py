"""Lane compaction (batch/compact.py) against the JAX package's.

  - the pure functions (`build_permutation`, `estimate_breaks`,
    `compact_decision`, `live_mask`, `function_key`, `divergence_key`)
    give the JAX results on seeded numpy inputs, parked (TRAP_HOSTCALL)
    and dead lanes included, and the JAX package's own pure tests
    (tests/test_compact.py:103-235) hold for the port's;
  - the divergence scores: the port's analyzer gives the JAX analyzer's
    `block_divergence`, block by block, on every fixture module and every
    corpus module, so both packages sort lanes alike;
  - end of run: `BatchEngine.run` and `run_mixed` with compaction on give
    what they give with it off and what the JAX engine gives (results,
    trap, retired), per op and in blocks; a repeated run starts from the
    identity mapping; the knob defaults to off and then nothing is armed.
The launch-by-launch parity is in test_torch_compact_launch.py and
test_torch_compact_host.py.
"""

import glob
import inspect

import numpy as np
import pytest
import torch

import wasmedge_tpu.batch.compact as R
from wasmedge_tpu.analysis import analyze_module as ref_analyze
from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.batch.multitenant import (
    MultiTenantBatchEngine as RefMultiTenant, Tenant as RefTenant)
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.configure import Proposal as RefProposal
from wasmedge_tpu.loader import Loader as RefLoader
from wasmedge_tpu.validator import Validator as RefValidator
import wasmedge_tpu_torch.batch.compact as P
from wasmedge_tpu_torch import models
from wasmedge_tpu_torch.analysis.analyzer import analyze_module
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.image import TRAP_DONE, TRAP_HOSTCALL
from wasmedge_tpu_torch.batch.multitenant import (
    MultiTenantBatchEngine, Tenant)
from wasmedge_tpu_torch.common.configure import Configure, Proposal
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import build_fib, build_loop_sum
from wasmedge_tpu_torch.models import fixtures
from wasmedge_tpu_torch.models.fixtures import (
    compact_conf, div_args, fib_model, loop_sum_model)
from wasmedge_tpu_torch.utils.wat import compile_module_fields, parse_wast
from wasmedge_tpu_torch.validator import Validator
from tests.test_torch_multitenant import inst_of

LANES = 16


# ---------------------------------------------------------------------------
# the pure functions against the JAX package's
# ---------------------------------------------------------------------------
def _population(rng, n):
    pc = rng.integers(0, 50, n).astype(np.int64)
    trap = rng.choice([0, 0, 0, TRAP_DONE, 3, TRAP_HOSTCALL],
                      n).astype(np.int64)
    return pc, trap


@pytest.mark.parametrize("n", [1, 7, 32, 257, 4096])
def test_permutation_and_breaks_equal_jax(n):
    rng = np.random.default_rng(n)
    for _ in range(4):
        pc, trap = _population(rng, n)
        dscore = rng.integers(0, 9, 50).astype(np.int32)
        fnkey = np.sort(rng.integers(0, 4, 50)).astype(np.int64)
        np.testing.assert_array_equal(P.live_mask(trap), R.live_mask(trap))
        for kw in ({}, {"dscore": dscore}, {"fnkey": fnkey},
                   {"dscore": dscore, "fnkey": fnkey}):
            np.testing.assert_array_equal(P.build_permutation(pc, trap, **kw),
                                          R.build_permutation(pc, trap, **kw))
        live = R.live_mask(trap)
        assert P.estimate_breaks(pc, live) == R.estimate_breaks(pc, live)
        shards = [slice(0, n // 3), slice(n // 3, n)]
        assert P.estimate_breaks(pc, live, shards) \
            == R.estimate_breaks(pc, live, shards)


def test_compact_decision_equals_jax():
    rng = np.random.default_rng(7)
    for case in range(200):
        n = int(rng.choice([4, 16, 40, 64, 300]))
        pc, trap = _population(rng, n)
        if case % 5 == 0:
            trap[:] = TRAP_DONE   # idle
        knobs, ref_knobs = Configure().batch, RefConfigure().batch
        for k, v in (("compact_min_interval", int(rng.integers(1, 4))),
                     ("compact_trigger", float(rng.choice([0.0, 0.05, 0.5]))),
                     ("compact_cost_factor",
                      float(rng.choice([0.0, 4.0, 100.0]))),
                     ("compact_width_floor", int(rng.choice([1, 4, 64])))):
            setattr(knobs, k, v)
            setattr(ref_knobs, k, v)
        width = int(rng.integers(1, n + 1))
        args = (width, int(rng.choice([1, 48, 1 << 20])),
                int(rng.integers(0, 5)))
        narrow = bool(rng.integers(2))
        got = P.compact_decision(pc, trap, *args, knobs, narrow)
        want = R.compact_decision(pc, trap, *args, ref_knobs, narrow)
        assert tuple(got) == tuple(want), case


def test_compact_defaults_equal_jax():
    port, ref = Configure().batch, RefConfigure().batch
    for k in ("compact", "compact_min_interval", "compact_trigger",
              "compact_cost_factor", "compact_narrow",
              "compact_width_floor"):
        assert getattr(port, k) == getattr(ref, k), k
    assert port.compact is False


# ---------------------------------------------------------------------------
# the JAX package's pure tests (tests/test_compact.py:103-235), on the port
# ---------------------------------------------------------------------------
def test_permutation_is_a_bijection():
    rng = np.random.default_rng(0)
    for n in (1, 7, 32, 257):
        pc, trap = _population(rng, n)
        perm = P.build_permutation(pc, trap)
        assert sorted(perm.tolist()) == list(range(n))


def test_permutation_shard_blocked_is_a_bijection_within_shards():
    rng = np.random.default_rng(1)
    n, shards = 32, [slice(0, 8), slice(8, 16), slice(16, 32)]
    pc = rng.integers(0, 9, n).astype(np.int64)
    trap = rng.choice([0, 0, TRAP_DONE], n).astype(np.int64)
    perm = P.build_permutation(pc, trap, shard_slices=shards)
    assert sorted(perm.tolist()) == list(range(n))
    for sl in shards:
        assert all(sl.start <= s < sl.stop for s in perm[sl])


def test_permutation_sorts_live_prefix_by_pc_stable():
    pc = np.asarray([9, 2, 9, 2, 5], np.int64)
    trap = np.asarray([0, TRAP_DONE, 0, 0, 0], np.int64)
    assert P.build_permutation(pc, trap).tolist() == [3, 4, 0, 2, 1]


def test_divergence_bias_groups_high_scores_first():
    pc = np.asarray([1, 7, 1, 7], np.int64)
    dscore = np.zeros(8, np.int64)
    dscore[7] = 5
    assert P.build_permutation(pc, np.zeros(4, np.int64),
                               dscore=dscore).tolist() == [1, 3, 0, 2]


def test_function_key_groups_lanes_per_function():
    pc = np.asarray([12, 1, 11, 3, 10, 2], np.int64)
    trap = np.zeros(6, np.int64)
    fnkey = np.asarray([0] * 10 + [1] * 10, np.int64)
    dscore = np.zeros(20, np.int64)
    dscore[12] = 9
    assert P.build_permutation(pc, trap, dscore=dscore,
                               fnkey=fnkey).tolist() == [1, 5, 3, 0, 4, 2]
    assert P.build_permutation(pc, trap, dscore=dscore).tolist() \
        == [0, 1, 5, 3, 4, 2]

    class _Img:
        f_entry = np.asarray([0, 10, -1], np.int64)
        code_len = 20

    assert P.function_key(_Img()).tolist() == [0] * 10 + [1] * 10

    class _Broken:
        f_entry = None
        code_len = 20

    assert P.function_key(_Broken()) is None


def test_anti_thrash_quantum():
    pc = np.asarray([3, 1, 3, 1], np.int64)
    trap = np.zeros(4, np.int64)
    knobs = Configure().batch
    knobs.compact_min_interval = 4
    knobs.compact_trigger = 0.0
    knobs.compact_cost_factor = 0.0
    early = P.compact_decision(pc, trap, 4, 48, 3, knobs, False)
    assert not early.fire and early.reason == "interval"
    assert P.compact_decision(pc, trap, 4, 48, 4, knobs, False).fire


def test_cost_model_deterministic_and_gating():
    pc = np.asarray([3, 1, 3, 1], np.int64)
    trap = np.zeros(4, np.int64)
    knobs = Configure().batch
    a = P.compact_decision(pc, trap, 4, 48, 99, knobs, False)
    assert a == P.compact_decision(pc, trap, 4, 48, 99, knobs, False)
    assert a.fire          # 2 * 48 >= 4.0 * 4
    knobs.compact_cost_factor = 1000.0
    c = P.compact_decision(pc, trap, 4, 48, 99, knobs, False)
    assert not c.fire and c.reason == "cost"
    idle = P.compact_decision(pc, np.full(4, TRAP_DONE, np.int64), 4, 48,
                              99, knobs, False)
    assert not idle.fire and idle.reason == "idle"


def test_estimate_breaks_and_live_mask():
    pc = np.asarray([5, 5, 9, 5], np.int64)
    trap = np.asarray([0, 0, 0, TRAP_HOSTCALL], np.int64)
    assert P.live_mask(trap).all()   # parked lanes stay live
    breaks, ideal, unique, largest = P.estimate_breaks(pc, P.live_mask(trap))
    assert (breaks, ideal, unique) == (2, 1, 2)
    assert largest == pytest.approx(0.75)


def test_estimate_breaks_shard_blocked_ideal():
    pc = np.asarray([3, 3, 7, 7, 3, 3, 7, 7], np.int64)
    live = np.ones(8, bool)
    shards = [slice(0, 4), slice(4, 8)]
    breaks, ideal, unique, largest = P.estimate_breaks(pc, live, shards)
    assert breaks == ideal == 2
    assert unique == 2 and largest == pytest.approx(0.5)
    pc2 = np.asarray([7, 3, 7, 3, 3, 3, 7, 7], np.int64)
    b2, i2, _, _ = P.estimate_breaks(pc2, live, shards)
    assert b2 - i2 > 0


# ---------------------------------------------------------------------------
# divergence scores: the port's analyzer against the JAX analyzer
# ---------------------------------------------------------------------------
def _fixture_modules():
    """(name, wasm bytes) of every fixture and workload module that a
    builder makes without arguments."""
    out = []
    for mod in (models, fixtures):
        for name, fn in sorted(vars(mod).items()):
            if not name.startswith("build_") or not callable(fn):
                continue
            if any(p.default is inspect.Parameter.empty
                   for p in inspect.signature(fn).parameters.values()):
                continue
            data = fn()
            parts = data if isinstance(data, tuple) else (data,)
            out += [(f"{name}[{i}]", d) for i, d in enumerate(parts)]
    return out


def _corpus_modules():
    out = []
    for path in sorted(glob.glob("tests/spec/*.wast")):
        for k, cmd in enumerate(parse_wast(open(path).read())):
            if cmd.kind == "module":
                out.append((f"{path}:{k}", compile_module_fields(cmd.fields),
                            "tail_call" in path))
    return out


def _scores_equal(name, data, tail=True):
    conf, rconf = Configure(), RefConfigure()
    if tail:
        conf.add_proposal(Proposal.TailCall)
        rconf.add_proposal(RefProposal.TailCall)
    lowered = Validator(conf).validate(
        Loader(conf).parse_module(data)).lowered
    ref = ref_analyze(RefValidator(rconf).validate(
        RefLoader(rconf).parse_module(data)).lowered)
    port = analyze_module(lowered)
    assert [f.idx for f in port.funcs] == [f.idx for f in ref.funcs], name
    for pf, rf in zip(port.funcs, ref.funcs):
        assert pf.block_divergence == list(rf.block_divergence), \
            (name, pf.idx)
        assert [(b.start, b.end) for b in pf.cfg.blocks] == \
            [(b.start, b.end) for b in rf.cfg.blocks], (name, pf.idx)
    return sum(len(f.block_divergence) for f in port.funcs)


def test_divergence_scores_equal_jax_on_fixtures():
    mods = _fixture_modules()
    assert len(mods) > 40
    blocks = sum(_scores_equal(name, data) for name, data in mods)
    assert blocks > 500


def test_divergence_scores_equal_jax_on_corpus():
    mods = _corpus_modules()
    assert len(mods) >= 40
    for name, data, tail in mods:
        _scores_equal(name, data, tail)


def test_divergence_key_on_engine_images():
    """An engine's image: the per-pc keys equal the JAX engine's; a
    concatenated image has no analysis."""
    for build in (build_fib, models.build_coremark_kernel,
                  models.build_memory_workload):
        port_inst, port_store = inst_of("port", build(), Configure())
        ref_inst, ref_store = inst_of("ref", build(), RefConfigure())
        eng = BatchEngine(port_inst, store=port_store, lanes=4,
                          device="cpu")
        ref = RefEngine(ref_inst, store=ref_store, lanes=4)
        np.testing.assert_array_equal(P.divergence_key(eng.img),
                                      R.divergence_key(ref.img))
        np.testing.assert_array_equal(P.function_key(eng.img),
                                      R.function_key(ref.img))
    mt = _mixed("port", Configure())
    assert P.divergence_key(mt.img) is None
    assert P.function_key(mt.img) is not None


# ---------------------------------------------------------------------------
# end of run: compaction on = off = the JAX engine
# ---------------------------------------------------------------------------
def _conf(pkg, compact, fusion=None):
    conf = (Configure if pkg == "port" else RefConfigure)()
    conf.batch.steps_per_launch = 48
    conf.batch.value_stack_depth = 128
    conf.batch.call_stack_depth = 64
    if compact:
        compact_conf(conf)
    if pkg == "port":
        conf.batch.block_fusion = fusion
    else:
        conf.batch.fuse_superinstructions = False
        conf.batch.tierup = False
    return conf


def _assert_same(a, b):
    for x, y in zip(a.results, b.results):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.trap, b.trap)
    np.testing.assert_array_equal(a.retired, b.retired)


@pytest.mark.parametrize("fusion", [None, False])
def test_run_compacted_equals_uncompacted_and_jax(fusion):
    ns = div_args(LANES)

    def run(pkg, compact):
        conf = _conf(pkg, compact, fusion)
        inst, store = inst_of(pkg, build_fib(), conf)
        if pkg == "port":
            eng = BatchEngine(inst, store=store, conf=conf, lanes=LANES,
                              device="cpu")
        else:
            eng = RefEngine(inst, store=store, conf=conf, lanes=LANES)
        return eng.run("fib", [ns], max_steps=500_000), eng

    on, eng = run("port", True)
    off, eng_off = run("port", False)
    ref, ref_eng = run("ref", True)
    assert eng.compactor.stats["fires"] >= 1
    assert eng.compactor.stats["min_width"] < LANES
    assert eng_off.compactor is None
    assert eng.compactor.stats == ref_eng.compactor.stats
    _assert_same(on, off)
    _assert_same(on, ref)
    np.testing.assert_array_equal(on.results[0], fib_model(ns))
    assert eng.compactor.stats["dispatch_slots"] < on.steps * LANES
    # a second run starts from the identity mapping
    again = eng.run("fib", [ns], max_steps=500_000)
    _assert_same(again, on)


def _mixed(pkg, conf):
    rows = ((build_fib(), "fib", [div_args(8, 4, 9, seed=5)]),
            (build_loop_sum(), "loop_sum",
             [(20 + 13 * np.arange(8)).astype(np.int64)]))
    tenants = []
    for data, fn, args in rows:
        inst, store = inst_of(pkg, data, conf)
        if pkg == "port":
            tenants.append(Tenant(engine=BatchEngine(
                inst, store=store, conf=conf, lanes=8, device="cpu"),
                func_name=fn, args_lanes=args, lanes=8))
        else:
            tenants.append(RefTenant(engine=RefEngine(
                inst, store=store, conf=conf, lanes=8),
                func_name=fn, args_lanes=args, lanes=8))
    if pkg == "port":
        return MultiTenantBatchEngine(tenants, conf=conf, device="cpu")
    return RefMultiTenant(tenants, conf=conf)


def test_run_mixed_compacted_equals_uncompacted_and_jax():
    mt = _mixed("port", _conf("port", True))
    on = mt.run_tenants(max_steps=500_000)
    off = _mixed("port", _conf("port", False)).run_tenants(
        max_steps=500_000)
    ref_mt = _mixed("ref", _conf("ref", True))
    ref_mt.use_pallas = False
    ref_mt._try_pallas = lambda: None   # the SIMT path, as the port runs
    ref = ref_mt.run_tenants(max_steps=500_000)
    assert mt.compactor.stats["fires"] >= 1
    assert mt.compactor.stats == ref_mt.compactor.stats
    for a, b, c in zip(on, off, ref):
        _assert_same(a, b)
        _assert_same(a, c)
        assert a.completed.all()
    np.testing.assert_array_equal(on[0].results[0],
                                  fib_model(div_args(8, 4, 9, seed=5)))
    np.testing.assert_array_equal(
        on[1].results[0] & 0xFFFFFFFF,
        loop_sum_model(20 + 13 * np.arange(8)) & 0xFFFFFFFF)


def test_compaction_off_is_the_uncompacted_path(monkeypatch):
    """With the knob off (the default) nothing is armed, read back,
    permuted or narrowed: every launch gets the state's planes whole and
    no width."""
    import wasmedge_tpu_torch.batch.engine as engine_mod

    calls = []
    orig = engine_mod.run_chunk

    def spy(*a, **k):
        calls.append(dict(k))
        return orig(*a, **k)

    monkeypatch.setattr(engine_mod, "run_chunk", spy)
    conf = _conf("port", False)
    assert conf.batch.compact is False
    inst, store = inst_of("port", build_fib(), conf)
    eng = BatchEngine(inst, store=store, conf=conf, lanes=LANES,
                      device="cpu")
    res = eng.run("fib", [div_args(LANES)], max_steps=500_000)
    assert eng.compactor is None and calls
    assert all("width" not in k for k in calls)
    np.testing.assert_array_equal(res.results[0], fib_model(div_args(LANES)))


def test_warp_state_and_shadows_survive_a_permutation():
    """B3's per-warp state stays with the warp (it is not a lane plane),
    and the snapshot's shadow planes, keyed by the state's geometry, are
    the same tensors after a permutation gives the state new planes."""
    from wasmedge_tpu_torch.batch.optimistic import WarpState

    conf = _conf("port", True)
    inst, store = inst_of("port", build_fib(), conf)
    eng = BatchEngine(inst, store=store, conf=conf, lanes=40, device="cpu")
    st = eng.initial_state(eng.export_func_idx("fib"), [div_args(40)])
    warps = WarpState.new(40, "cpu")
    warps.snap[:] = torch.tensor([300, 700], dtype=torch.int32)
    shadows = dict(warps.shadows_for(st, False))
    comp = P.LaneCompactor(eng)
    before = {f: p.clone() for f, p in st.planes().items()}
    perm = np.random.default_rng(5).permutation(40)
    comp.permute_state(st, perm)
    assert set(P.lane_plane_names(st, 40)) == set(st.planes())
    for f, p in st.planes().items():
        assert torch.equal(p, before[f][..., torch.as_tensor(perm)]), f
        assert p.is_contiguous() and p.dtype == torch.int32
    again = warps.shadows_for(st, False)
    assert all(again[k] is v for k, v in shadows.items())
    assert warps.snap.tolist() == [300, 700]
    np.testing.assert_array_equal(comp.src, perm)
    assert comp.stats["moved_lanes"] == int((perm != np.arange(40)).sum())
