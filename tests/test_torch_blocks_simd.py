"""Fused encodings on v128, bulk-memory and host-call modules, launch by launch.

As `test_torch_blocks.py`: the reference SIMT `BatchEngine` and the port's
plain engine from the same image and state, the live planes equal after
every launch.  Here "blocks" on vmix and vloop (four-word cells: a fused
block writes e2/e3 as the per-op step does, zero under scalar results,
all four words for moves), on the bulk workload (memory.fill and
memory.copy as block terminals) and, with "super" too, on modules whose
lanes park at host calls (the park as a terminal, then the serve round):
one launch and its serve round per call, stdout compared for WASI echo.
"""

import os

import numpy as np
import pytest

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.image import TRAP_HOSTCALL
from wasmedge_tpu_torch.batch.interp import device_tables
from wasmedge_tpu_torch.models import (
    build_bulk_workload, build_echo, build_simd_loop)
from wasmedge_tpu_torch.models.fixtures import build_host_double, build_vmix
from wasmedge_tpu_torch.models.programs import ECHO_MESSAGE
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_blocks import assert_live_planes, per_launch
from tests.test_torch_hostcall import (
    _env_import, _port_engine, _ref_conf, _wasi)
from tests.test_torch_interp import _image_of, _ref_planes

CASES = {
    "vmix": (build_vmix, "vmix", [np.arange(8) % 5 + 2], 13),
    "vloop": (build_simd_loop, "vloop", [np.arange(8) % 6], 7),
    "bulk_workload": (lambda: build_bulk_workload(
        fill_bytes=700, copy_bytes=300, fold_words=40), "bulk",
        [np.arange(4) * 37 + 5, np.full(4, 2)], 64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_match_simt_every_launch(case):
    build, func, args, chunk = CASES[case]
    port, tables, _ = per_launch("blocks", build(), func, args, chunk)
    assert tables.shapes
    assert (port.trap.numpy() == -1).all()
    if case != "bulk_workload":
        assert tables.has_simd and port.stack_e2 is not None


def _host_per_launch(fusion, data, func, args, ref_imports, port_imports,
                     chunk, max_calls=400):
    """One launch and its serve round per call on both engines, the live
    planes equal after every call."""
    lanes = len(np.asarray(args[0]))
    conf = _ref_conf(chunk=chunk)
    _, store, inst = ref_instantiate(data, conf, imports=ref_imports)
    ref = RefEngine(inst, store=store, conf=conf, lanes=lanes)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    eng, _ = _port_engine(data, port_imports, lanes, chunk=chunk)
    eng.img = _image_of(ref.img)
    eng.tables = device_tables(eng.img, "cpu", fusion)
    port = state_from_reference(_ref_planes(st), device="cpu")
    total = 0
    for call in range(max_calls):
        st, total_ref = ref.run_from_state(st, total, total + 1)
        port, total_port = eng.run_from_state(port, total, total + 1)
        assert total_port == total_ref, f"call {call}"
        want, got = _ref_planes(st), port.to_numpy()
        assert_live_planes(got, want, f"call {call}")
        assert not (got["trap"] == TRAP_HOSTCALL).any()
        total = total_ref
        if not (want["trap"] == 0).any():
            return port, eng
    raise AssertionError("reference still running after max_calls")


@pytest.mark.parametrize("fusion", ["blocks", "super"])
def test_host_calls_park_and_serve_fused(fusion):
    port, eng = _host_per_launch(
        fusion, build_host_double(), "f", [np.arange(8) * 10 - 7],
        [_env_import("ref")], [_env_import("port")], chunk=13)
    assert (port.trap.numpy() == -1).all()
    assert eng.hostcall_stats["serve_rounds"] > 0


@pytest.mark.parametrize("fusion", ["blocks", "super"])
def test_wasi_echo_fused_stdout(fusion, tmp_path):
    paths = [tmp_path / k for k in ("ref", "port")]
    fds = [os.open(p, os.O_RDWR | os.O_CREAT | os.O_TRUNC) for p in paths]
    try:
        port, _ = _host_per_launch(
            fusion, build_echo(), "echo", [np.full(4, 2)],
            [_wasi("ref", fds[0])], [_wasi("port", fds[1])], chunk=64)
    finally:
        for fd in fds:
            os.close(fd)
    outs = [p.read_bytes() for p in paths]
    assert outs[0] == outs[1] == ECHO_MESSAGE * 16
    assert (port.trap.numpy() == -1).all()
