"""The `mem_hbm` and `optimistic` knobs: the port's choices against the JAX package's.

`batch.engine.mem_window_of` chooses the window cache (B4) as
`PallasUniformEngine._mem_mode` (wasmedge_tpu/batch/pallas_engine.py
:3995-4013) chooses its HBM window mode, at the geometry the port runs
(4096 lanes, one page per lane, BASELINE config 2's stacks): the same
answer for `mem_hbm` None, True and False on an image with a memory and
on one without.  The engine carries the choice into its tables.

`optimistic` has the JAX field's default (None, which means on), and
`batch.engine.optimistic_of` reads it as `PallasUniformEngine` does
(pallas_engine.py :3921-3922): None and True give optimistic convergence
(B3), False the careful kernel; the engine carries it into its tables and
keeps its per-warp state only when it is on.
"""

import numpy as np
import pytest

from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu_torch.batch.engine import (
    BatchEngine, mem_window_of, memory_words, optimistic_of)
from wasmedge_tpu_torch.batch.interp import device_tables
from wasmedge_tpu_torch.batch.memwin import HBM_WINDOW_ROWS
from wasmedge_tpu_torch.common.configure import BatchConfigure, Configure
from wasmedge_tpu_torch.executor.instantiate import instantiate
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import (
    build_coremark_kernel, build_fib, build_memory_workload)
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.validator import Validator
from tests.helpers import instantiate as ref_instantiate

LANES = 4096
GEOMETRY = dict(value_stack_depth=128, call_stack_depth=64,
                memory_pages_per_lane=1)
MODULES = {"fib": build_fib, "mem_checksum": build_memory_workload,
           "coremark": build_coremark_kernel}


def _ref_mode(data, mem_hbm):
    from wasmedge_tpu.batch.pallas_engine import PallasUniformEngine

    conf = RefConfigure()
    for k, v in GEOMETRY.items():
        setattr(conf.batch, k, v)
    conf.batch.mem_hbm = mem_hbm
    _, store, inst = ref_instantiate(data, conf)
    eng = PallasUniformEngine(inst, store=store, conf=conf, lanes=LANES,
                              interpret=True)
    return eng._mem_mode()


def _port_engine(data, mem_hbm, lanes=4):
    conf = Configure()
    for k, v in GEOMETRY.items():
        setattr(conf.batch, k, v)
    conf.batch.mem_hbm = mem_hbm
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    inst = instantiate(StoreManager(), mod, conf)
    return BatchEngine(inst, conf=conf, lanes=lanes, device="cpu")


@pytest.mark.parametrize("mem_hbm", [None, True, False])
@pytest.mark.parametrize("name", list(MODULES))
def test_mem_window_of_matches_mem_mode(name, mem_hbm):
    data = MODULES[name]()
    eng = _port_engine(data, mem_hbm)
    want = _ref_mode(data, mem_hbm)
    assert mem_window_of(mem_hbm, eng.img) is want
    assert eng.mem_window is want and eng.tables.mem_window is want


def test_knob_defaults_to_the_windows():
    assert BatchConfigure().mem_hbm is None
    eng = _port_engine(build_memory_workload(), None)
    assert memory_words(eng.img) >= 2 * HBM_WINDOW_ROWS
    assert eng.tables.mem_window


def test_no_window_without_a_memory():
    eng = _port_engine(build_fib(), True)
    assert memory_words(eng.img) == 1 and not eng.tables.mem_window
    with pytest.raises(ValueError):
        device_tables(eng.img, "cpu", mem_window=True)


def test_both_modes_give_the_same_result():
    res = [_port_engine(build_memory_workload(), m, lanes=3).run(
        "mem_checksum", [np.array([1, 129, 300])]) for m in (True, False)]
    np.testing.assert_array_equal(res[0].results[0], res[1].results[0])
    np.testing.assert_array_equal(res[0].retired, res[1].retired)
    assert (res[0].trap == -1).all()


def test_optimistic_has_the_jax_default():
    assert BatchConfigure().optimistic is None
    assert RefConfigure().batch.optimistic is None


def _ref_optimistic(data, optimistic):
    from wasmedge_tpu.batch.pallas_engine import PallasUniformEngine

    conf = RefConfigure()
    conf.batch.optimistic = optimistic
    _, store, inst = ref_instantiate(data, conf)
    return PallasUniformEngine(inst, store=store, conf=conf, lanes=8,
                               interpret=True).optimistic


@pytest.mark.parametrize("optimistic", [None, True, False])
def test_optimistic_of_follows_the_pallas_engine(optimistic):
    conf = Configure()
    conf.batch.optimistic = optimistic
    mod = Validator(conf).validate(Loader(conf).parse_module(build_fib()))
    inst = instantiate(StoreManager(), mod, conf)
    eng = BatchEngine(inst, conf=conf, lanes=40, device="cpu")
    want = _ref_optimistic(build_fib(), optimistic)
    assert optimistic_of(optimistic) is want
    assert eng.optimistic is want and eng.tables.optimistic is want
    if want:
        assert eng.warps.snap.tolist() == [131072, 131072]
    else:
        assert eng.warps is None


def test_tier0_knob_defaults_match_reference():
    """The tier-0 knobs (wasmedge_tpu/common/configure.py:195-211): same
    names, same defaults; tier 0 on."""
    ref, port = RefConfigure().batch, BatchConfigure()
    for k in ("tier0_hostcalls", "rng_seed", "stdout_buffer_words",
              "tier0_write_max", "tier0_random_max"):
        assert getattr(port, k) == getattr(ref, k), k
    assert port.tier0_hostcalls is True
