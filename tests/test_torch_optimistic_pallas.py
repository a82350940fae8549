"""B3 end to end: the port with `optimistic` on against the Pallas kernel's optimistic mode on tests/test_optimistic.py's fixtures.

Each fixture of `tests/test_optimistic.py` at its 8 lanes (one partial
warp): `PallasUniformEngine(..., interpret=True)` with `optimistic` on
(the default; the lane-0 kernel, its canary, rollbacks and careful
rechecks) runs beside the port's engine on the CPU with `optimistic` on
(the plain version of the warp-leader fast path).  Results and traps must
be equal; `retired` must equal the JAX SIMT `BatchEngine`'s, which the
port counts exactly (Pallas's differs, ROADMAP C2).  The port's rollbacks
are at least 1 where the JAX test asserts `recheck_rounds >= 1`, and 0
where it asserts 0.  The port has no entry grouping (the JAX
`BlockScheduler` packs same-argument lanes into blocks,
pallas_engine.py:4519), so on the mixed arguments of
`test_grouped_divergent_args_never_roll_back` the port's one warp rolls
back once; at these 8 lanes in interpret mode the Pallas engine runs two
recheck rounds there, though the JAX test's name says none (ROADMAP C8):
the test states both counts.
The fixtures with a memory are in `test_torch_optimistic_pallas_mem.py`.
"""

import numpy as np
import pytest

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import ErrCode
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.executor.instantiate import instantiate
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import build_fib
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.utils.builder import ModuleBuilder
from wasmedge_tpu_torch.validator import Validator
from tests.helpers import instantiate as ref_instantiate

LANES = 8
STEPS = 50_000  # tests/test_optimistic.py make_engine's steps_per_launch
D, CD = 64, 32


def _knobs(b, hbm, optimistic):
    b.steps_per_launch = STEPS
    b.mem_hbm = hbm
    b.value_stack_depth, b.call_stack_depth = D, CD
    b.optimistic = optimistic


def pallas(data, func, args, hbm=None, optimistic=None, snap_steps=None,
           max_steps=500_000):
    """tests/test_optimistic.py's make_engine and run: the result and the
    engine (its recheck_rounds)."""
    from wasmedge_tpu.batch.pallas_engine import PallasUniformEngine

    conf = RefConfigure()
    _knobs(conf.batch, hbm, optimistic)
    _, store, inst = ref_instantiate(data, conf)
    eng = PallasUniformEngine(inst, store=store, conf=conf, lanes=LANES,
                              interpret=True)
    if snap_steps is not None:
        eng.SNAP_STEPS = snap_steps
    return eng.run(func, [np.asarray(a, np.int64) for a in args],
                   max_steps=max_steps), eng


def simt(data, func, args, hbm=None):
    """The JAX SIMT engine (superinstructions and tier-up off: one step
    per instruction), whose `retired` the port counts."""
    conf = RefConfigure()
    _knobs(conf.batch, hbm, False)
    conf.batch.fuse_superinstructions = False
    conf.batch.tierup = False
    _, store, inst = ref_instantiate(data, conf)
    return RefEngine(inst, store=store, conf=conf, lanes=LANES).run(
        func, [np.asarray(a, np.int64) for a in args], max_steps=10_000_000)


def port(data, func, args, hbm=None, optimistic=None, snap_max=None):
    """The port's engine on the CPU; the result and the engine."""
    conf = Configure()
    _knobs(conf.batch, hbm, optimistic)
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    inst = instantiate(StoreManager(), mod, conf)
    eng = BatchEngine(inst, conf=conf, lanes=LANES, device="cpu")
    if snap_max is not None:
        eng.warps = WarpState.new(LANES, "cpu", snap_max=snap_max)
    return eng.run(func, [np.asarray(a, np.int64) for a in args],
                   max_steps=10_000_000), eng


def compare(data, func, args, hbm=None, **kw):
    """Pallas and the port (both optimistic unless `optimistic` says
    otherwise): equal results on finished lanes and equal traps; the
    port's retired equal to the SIMT engine's.  Returns (pallas engine,
    port result, port engine)."""
    want, peng = pallas(data, func, args, hbm, **{
        k: v for k, v in kw.items() if k in ("optimistic", "snap_steps")})
    got, eng = port(data, func, args, hbm, **{
        k: v for k, v in kw.items() if k in ("optimistic", "snap_max")})
    np.testing.assert_array_equal(got.trap, want.trap)
    done = want.trap == -1
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(np.asarray(g)[done],
                                      np.asarray(w)[done])
    np.testing.assert_array_equal(got.retired,
                                  simt(data, func, args, hbm).retired)
    return peng, got, eng


def test_grouped_divergent_args_never_roll_back():
    args = [np.array([3, 3, 9, 9, 11, 3, 9, 11])]
    peng, got, eng = compare(build_fib(), "fib", args)
    assert peng.optimistic and eng.optimistic
    assert got.results[0].tolist() == [2, 2, 34, 34, 89, 2, 34, 89]
    # the port's warp holds all eight lanes and rolls back once; the
    # Pallas engine, grouping or not, rechecks twice at this geometry
    assert peng.recheck_rounds == 2
    assert eng.optimistic_stats["rollbacks"] == 1


def test_divergent_branch_recovers_via_recheck():
    peng, got, eng = compare(build_fib(), "fib", [np.arange(3, 11)])
    assert got.results[0].tolist() == [2, 3, 5, 8, 13, 21, 34, 55]
    assert peng.recheck_rounds >= 1
    assert eng.optimistic_stats["rollbacks"] >= 1


def _counter_loop() -> bytes:
    b = ModuleBuilder()
    b.add_function(["i32"], ["i32"], ["i32"], [
        ("block", None),
        ("loop", None),
        ("local.get", 1), ("i32.const", 1), "i32.add", ("local.set", 1),
        ("local.get", 0), ("local.get", 1), "i32.sub",
        ("br_if", 0),
        "end",
        "end",
        ("local.get", 1),
    ], export="f")
    return b.build()


def test_semantic_agreement_bitwise_differs_no_false_divergence():
    peng, got, eng = compare(_counter_loop(), "f",
                             [np.full(LANES, 50)])
    assert (got.results[0] == 50).all()
    assert peng.recheck_rounds == 0
    assert eng.optimistic_stats["rollbacks"] == 0
    assert eng.optimistic_stats["commits"] >= 1


def test_partial_lane_div_by_zero_rolls_back():
    b = ModuleBuilder()
    b.add_function(["i32", "i32"], ["i32"], [], [
        ("local.get", 0), ("local.get", 1), "i32.div_u",
    ], export="f")
    den = np.array([5, 5, 0, 5, 0, 5, 5, 5])
    _, got, eng = compare(b.build(), "f", [np.full(LANES, 100), den])
    for lane in range(LANES):
        if den[lane] == 0:
            assert got.trap[lane] == int(ErrCode.DivideByZero), lane
        else:
            assert got.trap[lane] == -1 and got.results[0][lane] == 20
    assert eng.optimistic_stats["rollbacks"] == 1


def test_careful_mode_forced_off():
    peng, got, eng = compare(build_fib(), "fib", [np.full(LANES, 10)],
                             optimistic=False)
    assert not peng.optimistic and not eng.optimistic
    assert not eng.tables.optimistic
    assert (got.results[0] == 55).all()
    assert peng.recheck_rounds == 0
    assert eng.optimistic_stats == {"entered": 0, "rollbacks": 0,
                                    "commits": 0}


def test_retired_counts_match_careful():
    a = [np.full(LANES, 14)]
    _, got, eng = compare(build_fib(), "fib", a)
    careful, _ = port(build_fib(), "fib", a, optimistic=False)
    assert got.retired.sum() == careful.retired.sum()
    assert eng.optimistic_stats["rollbacks"] == 0
