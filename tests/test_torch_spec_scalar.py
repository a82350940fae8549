"""The port's scalar spec harness against the JAX package's, file by file.

Each of the 23 files of tests/spec runs through the port's `run_corpus`
(the scalar engine on the host, a fresh store per file, every command
kind: module, module_quote, register, action, assert_return,
assert_trap, assert_exhaustion, assert_invalid, assert_malformed,
assert_unlinkable) with 0 failed and 0 skipped, and with the JAX scalar
`run_corpus`'s counts.  Both harnesses also run each file with their
callbacks recorded: every module accepted or refused with the same error
class, and every invocation giving the same raw cells or the same trap
code, command by command.  The stateful files every batched runner
skips (bulk_memory, memory, table, ref_types, globals) pass whole here.
"""

import glob
import os

import pytest

from wasmedge_tpu.common.configure import EngineKind
from wasmedge_tpu.common.errors import WasmError as RefWasmError
from wasmedge_tpu.spec import make_engine_callbacks as ref_callbacks
from wasmedge_tpu.spec import _conf_for_file as ref_conf_for_file
from wasmedge_tpu.spec import run_corpus as ref_run_corpus
from wasmedge_tpu_torch.common.errors import WasmError
from wasmedge_tpu_torch.spec import SCALAR_CORPUS_COUNTS as COUNTS
from wasmedge_tpu_torch.spec import (
    SpecTest, conf_for_file, make_engine_callbacks, run_corpus)

SPEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "spec")
FILES = sorted(os.path.basename(p)
               for p in glob.glob(os.path.join(SPEC_DIR, "*.wast")))


def test_the_corpus_is_the_23_files():
    assert FILES == sorted(COUNTS) and sum(COUNTS.values()) == 10135


@pytest.mark.parametrize("name", FILES)
def test_scalar_corpus_file_like_jax(name):
    path = os.path.join(SPEC_DIR, name)
    got = run_corpus([path])
    want = ref_run_corpus([path], EngineKind.SCALAR)
    assert [str(f) for f in got.failures] == []
    assert (got.passed, got.failed, got.skipped) == (COUNTS[name], 0, 0)
    assert (got.passed, got.failed, got.skipped) == \
        (want.passed, want.failed, want.skipped)


def _recorded(st, log):
    """Wrap a SpecTest's callbacks so that every call lands in `log`:
    ("module", name, accepted or the error's class and code) and
    ("invoke", field, args, raw cells or the trap code)."""
    on_module, on_invoke = st.on_module, st.on_invoke

    def module(name, data):
        try:
            inst = on_module(name, data)
        except (WasmError, RefWasmError) as e:
            log.append(("module", name, type(e).__name__, int(e.code)))
            raise
        except Exception as e:
            log.append(("module", name, type(e).__name__))
            raise
        log.append(("module", name, "ok"))
        return inst

    def invoke(inst, field, args):
        try:
            out = on_invoke(inst, field, args)
        except (WasmError, RefWasmError) as e:
            log.append(("invoke", field, list(args), int(e.code)))
            raise
        log.append(("invoke", field, list(args), [int(v) for v in out]))
        return out

    st.on_module, st.on_invoke = module, invoke
    return st


@pytest.mark.parametrize("name", FILES)
def test_each_command_like_jax(name):
    path = os.path.join(SPEC_DIR, name)
    with open(path) as f:
        src = f.read()
    port_log, ref_log = [], []
    port = _recorded(make_engine_callbacks(conf_for_file(path)), port_log)
    ref = ref_callbacks(EngineKind.SCALAR, ref_conf_for_file(path))
    ref = _recorded(ref, ref_log)
    got = port.run_script(src, name)
    want = ref.run_script(src, name)
    assert isinstance(port, SpecTest)
    assert len(port_log) == len(ref_log) > 0
    for k, (a, b) in enumerate(zip(port_log, ref_log)):
        assert a == b, (name, k)
    assert (got.passed, got.failed) == (want.passed, want.failed)
