"""The tail-dispatch workload on the port against the JAX package.

`models.fixtures.build_tail_dispatch` is a threaded-code interpreter: a
passive program segment copied in with memory.init, a table filled from a
passive element segment and changed per lane, and `n` steps of
return_call_indirect.  At small `n`, in both modes ("converged": one seed;
"divergent": seed = lane):

  - per launch against the reference SIMT `BatchEngine.run_from_state`,
    every plane equal after every launch, per-op, in B2 blocks and in B6
    superinstructions, `optimistic` on and off, `mem_hbm` on and off;
  - the results against the plain numpy model `tail_dispatch_model` (and
    its squaring against its step-by-step form);
  - `call_depth` stays at its entry value through every launch: a tail
    call replaces the frame;
  - converged warps enter uniform, the divergent mix never;
  - weighted gas (`tail_cost_table`: call_indirect and
    return_call_indirect 5, table instructions 3, the rest 1) with a
    fuel budget that runs out: every plane, trap (CostLimitExceeded at
    the right pc), `retired` and fuel equal the reference's per-op run
    launch by launch, in blocks too, where lanes run out inside a block.
"""

import numpy as np
import pytest

from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.models.fixtures import (
    build_tail_dispatch, tail_cost_table, tail_dispatch_args,
    tail_dispatch_model)
from tests.test_torch_tables import port_replay, ref_trajectory

LANES = 40
N = 12
CHUNK = 64
FUEL = 412  # runs out after about 9 steps, inside a handler's block
CONFIGS = [("none", None, None), ("none", False, False),
           ("none", None, False), ("blocks", None, None),
           ("blocks", False, False), ("super", None, False)]
_TRAJ = {}


def _traj(mode, gas):
    key = (mode, gas)
    if key not in _TRAJ:
        fuel, cost = (FUEL, tail_cost_table()) if gas else (None, None)
        _TRAJ[key] = ref_trajectory(build_tail_dispatch(), "run",
                                    tail_dispatch_args(LANES, mode, N),
                                    CHUNK, {}, fuel, cost)
    return _TRAJ[key]


def _depth_kept(before, after):
    live = after["trap"] == 0
    assert (after["call_depth"][live] == before["call_depth"][live]).all()
    assert (after["call_depth"] == 0).all()


@pytest.mark.parametrize("mode", ["converged", "divergent"])
@pytest.mark.parametrize("fusion,optimistic,mem_hbm", CONFIGS)
def test_tail_dispatch_matches_simt_every_launch(mode, fusion, optimistic,
                                                 mem_hbm):
    traj = _traj(mode, False)
    eng, port = port_replay(build_tail_dispatch(), traj, CHUNK, {}, fusion,
                            optimistic, mem_hbm, f"tail {mode}",
                            each=_depth_kept)
    args = tail_dispatch_args(LANES, mode, N)
    assert (port.trap.numpy() == -1).all()
    got = port.stack_lo[0].numpy().astype(np.int64) & 0xFFFFFFFF
    assert (got == tail_dispatch_model(args[0], N)).all()
    if eng.tables.optimistic:
        w = eng.warps
        uni, entered = int(w.uniform.sum()), int(w.entered.sum())
        if mode == "converged":
            # the whole warp (lanes 0-31) enters uniform every launch
            assert uni == len(traj[3]) and int(w.rollbacks.sum()) == 0
        else:
            assert uni == 0 and entered > 0


@pytest.mark.parametrize("n", [0, 1, 2, 255, 256, 257, 600])
def test_model_squares_as_it_steps(n):
    seeds = np.concatenate([np.arange(80), [2**31 - 1, 2**32 - 1, 12345]])
    assert (tail_dispatch_model(seeds, n)
            == tail_dispatch_model(seeds, n, steps=True)).all()


@pytest.mark.parametrize("mode", ["converged", "divergent"])
@pytest.mark.parametrize("fusion,optimistic", [("none", None),
                                               ("blocks", None),
                                               ("blocks", False),
                                               ("super", False)])
def test_weighted_gas_runs_out_on_the_right_op(mode, fusion, optimistic):
    traj = _traj(mode, True)
    eng, port = port_replay(build_tail_dispatch(), traj, CHUNK, {}, fusion,
                            optimistic, None, f"tail gas {mode}",
                            fuel=FUEL, cost=tail_cost_table())
    assert eng.tables.gcum is not None
    trap = port.trap.numpy()
    assert (trap == int(ErrCode.CostLimitExceeded)).all()
    if fusion == "blocks":
        # some lane ran out inside a block: at a pc that no block heads
        # but one covers, having run the block's head per op
        flen = eng.tables.flen.numpy()
        covered = np.zeros_like(flen, bool)
        for pc in np.nonzero(flen)[0]:
            covered[pc + 1:pc + flen[pc]] = True
        assert covered[port.pc.numpy()].any()


def test_weighted_gas_differs_from_flat_gas():
    """The same budget with flat gas goes further: more retired."""
    flat = ref_trajectory(build_tail_dispatch(), "run",
                          tail_dispatch_args(LANES, "divergent", N), CHUNK,
                          {}, FUEL, None)
    gas = _traj("divergent", True)
    assert (flat[3][-1][1]["retired"] > gas[3][-1][1]["retired"]).all()
