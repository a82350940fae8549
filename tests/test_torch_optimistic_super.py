"""B3 with B6 superinstructions: the port's plain version against the reference, launch by launch.

`test_torch_optimistic.py`'s fixtures without v128 ops (superinstructions
move two-word cells) and its check with the "super" encoding: the
reference SIMT `BatchEngine.run_from_state` and the port's plain
interpreter with `optimistic` on and off, one launch each; every plane
equal after every launch, the stack planes below sp.  A
superinstruction's branch takes the warp's lane 0 decision.
"""

import pytest

from tests.test_torch_optimistic import CASES, SIMD_CASES, check_case, modes


@pytest.mark.parametrize("case, mem_window", modes(
    [c for c in CASES if c not in SIMD_CASES]))
def test_super_matches_simt_every_launch(case, mem_window):
    check_case(case, "super", mem_window)
