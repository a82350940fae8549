"""Lane compaction launch by launch, against the JAX package.

The JAX `BatchEngine` (SIMT step, superinstruction fusion and tier-up
off) with its compactor armed and the policy held open (16 lanes, 48
steps a launch: `tests/test_compact.py`'s forced knobs) runs
`run_from_state(st, total, total + 1)` call by call: one boundary (which
may permute the lanes and narrow the width) and one launch each.  The
port's engine, over its own image (whose divergence scores come from its
own analyzer), replays the same calls from the same initial state.
After every call: results, trap, retired and every state plane (the
stack's rows below sp where a fused dispatch or B3 leaves dead rows),
the total, the compactor's `src`, its width and its stats are equal.
Per op and in B2 blocks, careful and optimistic; fib's divergent mix and
the CoreMark-style kernel (a memory: windows and direct access).  The
host-call and tier-0 fixtures are in test_torch_compact_host.py.
"""

import numpy as np
import pytest

from wasmedge_tpu.batch.compact import arm as ref_arm
from wasmedge_tpu.batch.compact import divergence_key as ref_dkey
from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu_torch.batch.compact import arm, divergence_key
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import (
    BatchEngine, mem_window_of, optimistic_of)
from wasmedge_tpu_torch.batch.interp import device_tables
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.models import build_coremark_kernel, build_fib
from wasmedge_tpu_torch.models.fixtures import (
    coremark_model, compact_conf, div_args, fib_model)
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_interp import _assert_planes, _ref_planes
from tests.test_torch_multitenant import inst_of

CHUNK = 48
D, CD = 128, 64
LANES = 16
CASES = {
    "fib": (build_fib, "fib", div_args(LANES), fib_model),
    "coremark": (build_coremark_kernel, "coremark",
                 div_args(LANES, 2, 17, seed=11) * 3, coremark_model),
}
# (encoding, optimistic, mem_hbm)
CONFIGS = {
    "fib": [("none", False, None), ("none", None, None),
            ("blocks", None, None), ("blocks", False, None)],
    "coremark": [("none", False, None), ("none", None, False),
                 ("blocks", None, None), ("blocks", False, False)],
}


def _knobs(conf, ref):
    b = conf.batch
    b.steps_per_launch = CHUNK
    b.value_stack_depth, b.call_stack_depth = D, CD
    compact_conf(conf)
    if ref:
        b.fuse_superinstructions = False
        b.tierup = False
    return conf


_TRAJ = {}


def trajectory(case):
    """The JAX run, call by call: (engine, initial planes, [(total,
    planes, src, width, stats)])."""
    if case not in _TRAJ:
        build, func, args, _ = CASES[case]
        conf = _knobs(RefConfigure(), True)
        _, store, inst = ref_instantiate(build(), conf)
        ref = RefEngine(inst, store=store, conf=conf, lanes=LANES)
        ref_arm(ref)
        st = ref.initial_state(ref.export_func_idx(func), [args])
        start, steps, total = _ref_planes(st), [], 0
        comp = ref.compactor
        while (np.asarray(st.trap) == 0).any():
            st, total = ref.run_from_state(st, total, total + 1)
            steps.append((total, _ref_planes(st), comp.src.copy(),
                          comp.width, dict(comp.stats)))
            assert len(steps) < 400
        _TRAJ[case] = (ref, start, steps)
    return _TRAJ[case]


def port_engine(case, fusion="none", optimistic=None, mem_hbm=None):
    build = CASES[case][0]
    conf = _knobs(Configure(), False)
    conf.batch.optimistic, conf.batch.mem_hbm = optimistic, mem_hbm
    inst, store = inst_of("port", build(), conf)
    eng = BatchEngine(inst, store=store, conf=conf, lanes=LANES,
                      device="cpu")
    if fusion != eng.fusion:
        eng.tables = device_tables(
            eng.img, "cpu", fusion,
            mem_window=mem_window_of(mem_hbm, eng.img),
            optimistic=optimistic_of(optimistic), stack_depth=D)
        eng.warps = WarpState.new(LANES, "cpu") if eng.tables.optimistic \
            else None
    return eng


def replay(eng, start, steps, where, exact):
    """The port's calls against the JAX trajectory; returns the state."""
    comp = arm(eng)
    port, total = state_from_reference(start, device="cpu"), 0
    for call, (want_total, want, src, width, stats) in enumerate(steps):
        port, total = eng.run_from_state(port, total, total + 1)
        at = f"{where} call {call}"
        assert total == want_total, at
        got = port.to_numpy()
        if exact:
            _assert_planes(got, want, at)
        else:
            assert_live_planes(got, want, at)
        np.testing.assert_array_equal(comp.src, src, err_msg=at)
        assert comp.width == width, at
        assert comp.stats == stats, at
    return port


@pytest.mark.parametrize("case,fusion,optimistic,mem_hbm",
                         [(c, *cfg) for c in CASES for cfg in CONFIGS[c]])
def test_compacted_launches_match_jax(case, fusion, optimistic, mem_hbm):
    ref, start, steps = trajectory(case)
    eng = port_engine(case, fusion, optimistic, mem_hbm)
    np.testing.assert_array_equal(divergence_key(eng.img),
                                  ref_dkey(ref.img))
    exact = fusion == "none" and not eng.tables.optimistic
    port = replay(eng, start, steps, f"{case} [{fusion}, opt={optimistic}, "
                  f"hbm={mem_hbm}]", exact)
    comp = eng.compactor
    assert comp.stats["fires"] >= 1 and comp.width < LANES
    assert len(comp.widths) == len(steps)
    # the lanes' results back in their order equal the numpy model
    order = comp.restore_order()
    _, _, args, model = CASES[case]
    got = port.stack_lo[0].numpy()[order].astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(got, model(args) & 0xFFFFFFFF)
