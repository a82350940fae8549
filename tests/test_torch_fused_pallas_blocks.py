"""B2 fused basic blocks, end of run: the port against the reference Pallas kernel and the scalar oracle.

`test_torch_fused_pallas.py`'s check with `block_fusion` True on both
sides: the port's plain engine runs its "blocks" encoding and
`PallasUniformEngine(..., interpret=True)` its `mk_block` handlers.
(The trap zoo, the slowest case, is in `test_torch_fused_pallas_zoo.py`.)
"""

import pytest

from tests.test_torch_fused_pallas import CASES, check_end_of_run


@pytest.mark.parametrize("case", [c for c in CASES if c != "trap_zoo"])
def test_blocks_end_of_run_matches_pallas_and_scalar(case):
    check_end_of_run(case, True)
