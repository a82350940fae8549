"""A concatenated image launch by launch: the JAX package's
MultiTenantBatchEngine on its SIMT path (use_pallas, superinstruction
fusion and tier-up off) and the port's, from the same initial state
(carried across with batch/convert.py), each launch `run_from_state(st,
total, total + 1)` on both sides, host calls served in between: results,
trap, retired and every state plane equal after every launch (the
table and segment planes of two table-zoo tenants among them), per op
and in B2 blocks, with the window cache and with direct memory access.  The
port's own initial_state equals the JAX one plane by plane."""

import numpy as np
import pytest

from wasmedge_tpu.batch.compact import arm
from wasmedge_tpu.batch.multitenant import (
    MultiTenantBatchEngine as RefMultiTenant)
from wasmedge_tpu.common.configure import Proposal as RefProposal
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import mem_window_of, optimistic_of
from wasmedge_tpu_torch.batch.interp import device_tables
from wasmedge_tpu_torch.batch.multitenant import MultiTenantBatchEngine
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.common.configure import Proposal
from wasmedge_tpu_torch.models.fixtures import (
    C10_MAX_PAGES, C10_PAGES_PER_LANE, TABLE_ZOO_CAP, build_clash_a,
    build_grow_tenant, build_table_zoo, table_cases)
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_interp import _assert_planes, _ref_planes
from tests.test_torch_multitenant import CASES, _conf, tenants_of

CHUNK = 97
D, CD = 64, 16
# the small cases (config 5's four modules, clashing index spaces, a host
# call beside a trap) and the C10 pair (held apart: its grows differ)
CASES_LAUNCH = {**{k: CASES[k] for k in ("config5", "clash", "host_traps")},
                "c10": [(lambda m=m: build_grow_tenant(m), "g",
                         [np.array([1, 2, 3, 0, 4], np.int64)], 5, None)
                        for m in C10_MAX_PAGES]}
# two tenants of the table zoo (table.grow past the capacity, table.init
# and elem.drop; their table slots and segments rebased) beside clash_a
ZOO = table_cases(6, 20261018)
CASES_LAUNCH["tables"] = [
    (build_table_zoo, ZOO["grow"][0], ZOO["grow"][1], 6, None),
    (build_clash_a, "go", [np.array([4, 5, 6], np.int64)], 3, None),
    (build_table_zoo, ZOO["init"][0], ZOO["init"][1], 6, None)]
SAME = ("config5", "clash", "host_traps", "tables")
# (encoding, optimistic, mem_hbm): per op exactly, in blocks (B3 on, the
# default) on the rows below sp; windows (None) and direct (False)
CONFIGS = [("none", False, None), ("none", False, False),
           ("blocks", None, None), ("blocks", None, False)]


def _confs(pkg, case):
    conf = _conf(pkg, C10_PAGES_PER_LANE if case == "c10" else None)
    if case == "tables":
        conf.add_proposal((Proposal if pkg == "port" else RefProposal)
                          .TailCall)
        conf.batch.table_elems_per_lane = TABLE_ZOO_CAP
    b = conf.batch
    b.steps_per_launch = CHUNK
    b.value_stack_depth, b.call_stack_depth = D, CD
    return conf


def _tenants(pkg, case):
    conf = _confs(pkg, case)
    return tenants_of(pkg, CASES_LAUNCH[case], conf), conf


_TRAJ = {}


def _trajectory(case):
    """The JAX engine's initial state and its run, launch by launch."""
    if case not in _TRAJ:
        tenants, conf = _tenants("ref", case)
        ref = RefMultiTenant(tenants, conf=conf)
        arm(ref)  # run_tenants' set-up: no lane compaction
        st = ref.initial_state()
        start, steps, total = _ref_planes(st), [], 0
        while (np.asarray(st.trap) == 0).any():
            st, total = ref.run_from_state(st, total, total + 1)
            steps.append((total, _ref_planes(st)))
            assert len(steps) < 400
        _TRAJ[case] = (start, steps)
    return _TRAJ[case]


@pytest.mark.parametrize("fusion,optimistic,mem_hbm", CONFIGS)
@pytest.mark.parametrize("case", SAME)
def test_concatenated_image_every_launch(case, fusion, optimistic, mem_hbm):
    start, steps = _trajectory(case)
    tenants, conf = _tenants("port", case)
    conf.batch.optimistic = optimistic
    conf.batch.mem_hbm = mem_hbm
    eng = MultiTenantBatchEngine(tenants, conf=conf, device="cpu")
    if fusion != eng.fusion:
        eng.tables = device_tables(
            eng.img, "cpu", fusion,
            mem_window=mem_window_of(mem_hbm, eng.img),
            optimistic=optimistic_of(optimistic), stack_depth=D)
    eng.warps = WarpState.new(eng.lanes, "cpu") if eng.tables.optimistic \
        else None
    _assert_planes(eng.initial_state().to_numpy(), start, "initial state")
    port, total = state_from_reference(start, device="cpu"), 0
    for call, (want_total, want) in enumerate(steps):
        port, total = eng.run_from_state(port, total, total + 1)
        at = f"{case} [{fusion}, opt={optimistic}, hbm={mem_hbm}] " \
             f"launch {call}"
        assert total == want_total, at
        got = port.to_numpy()
        if fusion == "none" and not eng.tables.optimistic:
            _assert_planes(got, want, at)
        else:
            assert_live_planes(got, want, at)
    assert eng.tables.mem_window == (eng.img.has_memory
                                     and mem_hbm is not False)
    assert eng.t0kinds is None  # every host call is served at tier 1


def test_c10_trajectory_differs_from_jax_only_at_the_ceiling():
    """C10 launch by launch: the JAX SIMT engine grows tenant A past its
    declared maximum; with the port's own image (each grow's `b` its
    tenant's ceiling) A's lanes get -1 where the JAX run gave 1."""
    start, steps = _trajectory("c10")
    tenants, conf = _tenants("port", "c10")
    eng = MultiTenantBatchEngine(tenants, conf=conf, device="cpu")
    st, total = eng.run_from_state(eng.initial_state(), 0, 10_000)
    want = steps[-1][1]
    got = st.to_numpy()
    a, b = slice(0, 5), slice(5, 10)
    np.testing.assert_array_equal(got["stack_lo"][0, b],
                                  want["stack_lo"][0, b])
    assert got["stack_lo"][0, a].tolist() == [-1, -1, -1, 1, -1]
    assert want["stack_lo"][0, a].tolist() == [1, 1, 1, 1, -1]
    # A never grows: its pages stay at 1
    assert got["mem_pages"][a].tolist() == [1] * 5
