"""B3 with B2 fused blocks: the port's plain version against the reference, launch by launch.

`test_torch_optimistic.py`'s fixtures and check with the "blocks"
encoding: the reference SIMT `BatchEngine.run_from_state` and the port's
plain interpreter with `optimistic` on and off, one launch each; every
plane equal after every launch, the stack planes below sp (a fused block
leaves the cells that die inside it unwritten, a rolled-back wrong path
the rows above sp).  Divergent fixtures roll back, converged ones do
not; each fixture with a memory runs in both memory modes.  A block's
guards, inline loads and stores take the warp's lane 0 decisions.
"""

import pytest

from tests.test_torch_optimistic import CASES, check_case, modes


@pytest.mark.parametrize("case, mem_window", modes(CASES))
def test_blocks_match_simt_every_launch(case, mem_window):
    _, warps = check_case(case, "blocks", mem_window)
    assert warps.snap_max == 131072
