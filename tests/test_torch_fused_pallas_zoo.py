"""B2 fused basic blocks on the trap zoo, end of run: the port against the reference Pallas kernel and the scalar oracle.

`test_torch_fused_pallas_blocks.py`'s check on its slowest case, in a
file of its own so that each file stays short on one test worker.
"""

from tests.test_torch_fused_pallas import check_end_of_run


def test_blocks_trap_zoo_end_of_run_matches_pallas_and_scalar():
    check_end_of_run("trap_zoo", True)
