"""B4, the memory window cache: the port with `mem_hbm` True against the reference engines.

End of run: the port's engine on the CPU with `mem_hbm` True (the plain
interpreter through `batch/memwin.py`) against
`PallasUniformEngine(..., interpret=True)` with `mem_hbm` True and
`optimistic` False (the careful kernel with the HBM plane behind its VMEM
window cache), results and traps, and against the scalar oracle
(`Executor.invoke`, one instance per lane).  Per launch: the reference's
image and state carried into the port, the reference SIMT
`BatchEngine.run_from_state` and the port's windowed plain interpreter
one launch each, every plane equal after every launch (per-op: every
row; blocks: the stack rows below sp, as in test_torch_blocks.py).
Bit-exact throughout.  Fixtures: the window walk, mem_checksum and the
bulk zoo.
"""

import numpy as np
import pytest

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.interp import device_tables, run_chunk
from wasmedge_tpu_torch.models import build_memory_workload
from wasmedge_tpu_torch.models.fixtures import (
    build_bulk_zoo, build_window_walk, bulk_zoo_args)
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_fused_pallas import _scalar
from tests.test_torch_interp import (
    CD, D, PAGES, _assert_planes, _image_of, _port_run, _ref_conf,
    _ref_planes)

CASES = {
    "window_walk": (build_window_walk, "edgewalk",
                    [np.array([3, 7, 12, 20, 33, 50, 64, 90])]),
    "mem_checksum": (build_memory_workload, "mem_checksum",
                     [np.array([1, 5, 40, 127, 128, 129, 200, 300])]),
    "bulk_copy": (build_bulk_zoo, "copy", bulk_zoo_args(8, "copy", 11)),
}


def _pallas_hbm(data, func, args):
    from wasmedge_tpu.batch.pallas_engine import PallasUniformEngine

    conf = RefConfigure()
    b = conf.batch
    b.steps_per_launch = 50_000
    b.value_stack_depth, b.call_stack_depth = D, CD
    b.memory_pages_per_lane = PAGES
    b.mem_hbm = True
    b.optimistic = False
    b.block_fusion = False
    b.fuse_superinstructions = False
    b.tierup = False
    _, store, inst = ref_instantiate(data, conf)
    eng = PallasUniformEngine(inst, store=store, conf=conf,
                              lanes=len(args[0]), interpret=True)
    assert eng.eligible, eng.ineligible_reason
    assert eng._mem_mode() is True
    return eng.run(func, [np.asarray(a, np.int64) for a in args])


@pytest.mark.parametrize("case", list(CASES))
def test_windows_end_of_run_match_pallas_hbm_and_scalar(case):
    build, func, args = CASES[case]
    got = _port_run(build(), func, args, len(args[0]), mem_hbm=True,
                    steps_per_launch=4096)
    want = _pallas_hbm(build(), func, args)
    np.testing.assert_array_equal(got.trap, want.trap)
    done = want.trap == -1
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g[done], w[done])
    for lane in range(len(args[0])):
        cells, code = _scalar(build(), func, args, lane)
        assert got.trap[lane] == code, (lane, got.trap[lane], code)
        for r, c in enumerate(cells or ()):
            assert int(got.results[r][lane]) & (2**64 - 1) == c, lane


@pytest.mark.parametrize("fusion", ["none", "blocks"])
@pytest.mark.parametrize("case", list(CASES))
def test_windows_match_simt_every_launch(case, fusion):
    build, func, args = CASES[case]
    chunk = 64
    conf = _ref_conf(None, chunk)
    _, store, inst = ref_instantiate(build(), conf)
    ref = RefEngine(inst, store=store, conf=conf, lanes=len(args[0]))
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    tables = device_tables(_image_of(ref.img), "cpu", fusion,
                           mem_window=True)
    port = state_from_reference(_ref_planes(st), device="cpu")
    total = 0
    for launch in range(2000):
        st, new_total = ref.run_from_state(st, total, total + chunk)
        run_chunk(tables, port, chunk, False)
        want = _ref_planes(st)
        if fusion == "none":
            _assert_planes(port.to_numpy(), want, f"launch {launch}")
        else:
            assert_live_planes(port.to_numpy(), want, f"launch {launch}")
        if new_total - total < chunk or not (want["trap"] == 0).any():
            break
        total = new_total
    else:
        raise AssertionError("reference still running")
    assert (port.trap.numpy() != 0).all()
