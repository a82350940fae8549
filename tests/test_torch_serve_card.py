"""On the card: a launch from a serving state just after an install
round (config 5's four modules in one MultiModuleBatchEngine, idle
TRAP_DONE lanes beside the installed ones, the window cache written back
at the last launch's exit), through the kernel and through its plain
version: every plane equal.  Skips without a CUDA device; imports no
JAX."""

import pytest
import torch

from wasmedge_tpu_torch.batch.multitenant import MultiModuleBatchEngine
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.executor import Executor
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import (
    build_coremark_kernel, build_fac, build_fib, build_loop_sum)
from wasmedge_tpu_torch.models.fixtures import serve_load
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.serve import BatchServer
from wasmedge_tpu_torch.validator import Validator

CONFIG5 = (("fib", build_fib), ("fac", build_fac),
           ("loop_sum", build_loop_sum), ("coremark", build_coremark_kernel))


def _inst(data, conf):
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    store = StoreManager()
    return Executor(conf).instantiate(store, mod), store


@pytest.mark.cuda
def test_cuda_launch_after_install_matches_plain():
    """On the card: a serving state just after an install round (config
    5's four modules, idle TRAP_DONE lanes, the window cache written back
    at the last launch's exit), one launch through the kernel and the
    plain version: every plane equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from wasmedge_tpu_torch.batch import interp_ref
    from wasmedge_tpu_torch.batch.interp import run_chunk
    from wasmedge_tpu_torch.batch.optimistic import WarpState

    conf = Configure()
    conf.batch.steps_per_launch = 256
    conf.batch.value_stack_depth, conf.batch.call_stack_depth = 128, 64
    modules = [(name, *_inst(build(), conf)) for name, build in CONFIG5]
    eng = MultiModuleBatchEngine(modules, conf=conf, lanes=70,
                                 device="cuda")
    srv = BatchServer(engine=eng)
    load = serve_load(80, 7, ranges={
        "fib": (5, 15), "fac": (1, 20), "loop_sum": (1, 3000),
        "coremark": (1, 200)})
    for t, f, n in load[:70]:
        srv.submit(f, [n], tenant=t)
    for _ in range(3):
        srv.step()
    for t, f, n in load[70:]:
        srv.submit(f, [n], tenant=t)
    with srv._lock:
        assert srv._admit(0.0) > 0
    st = srv.state
    assert (st.trap == -1).any()
    ref = st.clone()
    run_chunk(eng.tables, st, 300, False, WarpState.new(70, "cuda"))
    interp_ref.run_chunk(eng.tables, ref, 300, False,
                         WarpState.new(70, "cuda"))
    got, want = st.planes(), ref.planes()
    assert got.keys() == want.keys()
    for f in got:
        assert torch.equal(got[f], want[f]), f
