"""Tier 0's stdout flush on the port against the JAX package.

Each port run below records the input of every flush it makes (the
stdout plane `so_buf`, the fills `so_off` and the lanes' stream cursor,
position and high-water mark, as the flush found them).  Each recorded
input is then flushed again by both packages, each with its own WASI
environ writing fd 1 and fd 2 to files of its own and its own copy of
the cursor: the port's `flush_stdout_buffers` on CPU tensors (the plain
version, `_records`) and the JAX package's (`wasmedge_tpu/batch/
hostcall.py` `flush_stdout_buffers`).  The bytes on each fd, the bytes
returned, the cursor after it, the stats (`stdout_flushes`,
`stdout_bytes`) and the fills set to 0 must be equal.  The runs:

  - WASI echo and hello through `VM.execute_batch` (tier 0 on; hello's
    write of three iovecs is served on the host, so its flushes are
    empty);
  - the tier-0 zoo's `digit` lanes: different record counts a lane, fd 1
    and 2 interleaved, payloads from unaligned addresses, lengths of 1-3
    bytes (`digit_fd3` also parks fd 3's writes);
  - echo saved, run on, restored and finished, uncompacted and with lane
    compaction forced on (`test_torch_stdout_cursor.py`'s drive), whose
    flushes after the restore skip a replayed head below the high-water
    mark;
  - random planes: record lengths 0-40 to fd 1 or 2, lanes without
    records, random skips.

The `cuda` test holds the flush kernel (`batch/stdout_flush.py`) against
the plain version on the same inputs: each fd's bytes and each lane's
payload count.  Exact.
"""

import collections
import os
import types

import numpy as np
import pytest
import torch

from wasmedge_tpu.batch import hostcall as ref_hostcall
from wasmedge_tpu.host.wasi import WasiModule as RefWasiModule
import wasmedge_tpu_torch.batch.engine as port_engine_mod
from wasmedge_tpu_torch.batch import hostcall
from wasmedge_tpu_torch.common.configure import Configure, HostRegistration
from wasmedge_tpu_torch.host.wasi import WasiModule
from wasmedge_tpu_torch.models import build_echo, build_wasi_hello
from wasmedge_tpu_torch.models.fixtures import build_tier0_zoo, tier0_cases
from wasmedge_tpu_torch.vm.vm import VM
from tests import test_torch_stdout_cursor as cursor

LANES, SEED = 40, 20261018
_Flush = collections.namedtuple("_Flush", "so_buf so_off pos hw")
_RefState = collections.namedtuple("_RefState", "so_buf so_off")
# the port's flush itself (the `recorded` fixture wraps the module's name)
_FLUSH = hostcall.flush_stdout_buffers


@pytest.fixture
def recorded(monkeypatch):
    """The inputs of every flush the port makes while the test runs."""
    out = []
    real = hostcall.flush_stdout_buffers

    def rec(engine, state):
        if state.so_buf is not None:
            pos, hw = hostcall._stdout_cursor(engine, state.so_off.shape[0])
            out.append(_Flush(state.so_buf.numpy().copy(),
                              state.so_off.numpy().copy(), pos.copy(),
                              hw.copy()))
        return real(engine, state)

    monkeypatch.setattr(hostcall, "flush_stdout_buffers", rec)
    monkeypatch.setattr(port_engine_mod, "flush_stdout_buffers", rec)
    return out


def _run_vm(data, func, args, chunk, tmp_path, sw=2048):
    conf = Configure()
    conf.host_registrations.add(HostRegistration.Wasi)
    b = conf.batch
    b.lanes, b.steps_per_launch = LANES, chunk
    b.value_stack_depth, b.call_stack_depth = 64, 16
    b.memory_pages_per_lane = 1
    b.stdout_buffer_words = sw
    vm = VM(conf)
    vm.wasi_module.init_wasi(args=["alpha", "be"])
    fds = [os.open(tmp_path / f"run.{k}", os.O_RDWR | os.O_CREAT | os.O_TRUNC)
           for k in (1, 2)]
    vm.wasi_module.env.fds[1].os_fd, vm.wasi_module.env.fds[2].os_fd = fds
    try:
        vm.load_wasm(data)
        vm.validate()
        vm.instantiate()
        vm.execute_batch(func, args, device="cpu")
    finally:
        for fd in fds:
            os.close(fd)


def _random_flushes(rng, n) -> list:
    out = []
    for _ in range(n):
        L, SW = int(rng.choice([1, 7, 32, 33, 100])), 48
        buf = rng.integers(-2**31, 2**31, (SW, L)).astype(np.int32)
        off = np.zeros(L, np.int32)
        for lane in range(L):
            o = 0
            for _ in range(int(rng.integers(0, 6))):
                fd, ln = int(rng.integers(1, 3)), int(rng.integers(0, 41))
                nw = (ln + 3) // 4
                if o + 1 + nw > SW:
                    break
                buf[o, lane] = ln | (fd << 28)
                o += 1 + nw
            off[lane] = o
        pos = rng.integers(0, 200, L)
        hw = pos + np.where(rng.random(L) < 0.5, rng.integers(0, 60, L), 0)
        out.append(_Flush(buf, off, pos.astype(np.int64),
                          hw.astype(np.int64)))
    return out


def _flush_both(f: _Flush, tmp_path, k: int):
    """Flush `f` through both packages: (port, JAX), each (fd 1 bytes,
    fd 2 bytes, bytes returned, pos, hw, stats, fills after)."""
    out = []
    for pkg in ("port", "ref"):
        wasi = WasiModule() if pkg == "port" else RefWasiModule()
        wasi.init_wasi(args=[])
        paths = [tmp_path / f"{pkg}{k}.{fd}" for fd in (1, 2)]
        fds = [os.open(p, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
               for p in paths]
        wasi.env.fds[1].os_fd, wasi.env.fds[2].os_fd = fds
        host = types.SimpleNamespace(kind="host",
                                     host=types.SimpleNamespace(_env=wasi.env))
        eng = types.SimpleNamespace(
            inst=types.SimpleNamespace(funcs=[host]),
            hostcall_stats=dict(stdout_flushes=0, stdout_bytes=0,
                                flush_s=0.0),
            _stdout_cursor=(f.pos.copy(), f.hw.copy()))
        try:
            if pkg == "port":
                st = types.SimpleNamespace(so_buf=torch.from_numpy(f.so_buf),
                                           so_off=torch.from_numpy(
                                               f.so_off.copy()))
                ret = _FLUSH(eng, st)
                fills = st.so_off.numpy()
            else:
                st = ref_hostcall.flush_stdout_buffers(
                    eng, _RefState(f.so_buf, f.so_off.copy()))
                ret = None
                fills = np.asarray(st.so_off)
        finally:
            for fd in fds:
                os.close(fd)
        data = [p.read_bytes() for p in paths]
        stats = {k: eng.hostcall_stats[k]
                 for k in ("stdout_flushes", "stdout_bytes")}
        out.append((*data, ret, *eng._stdout_cursor, stats, fills))
    return out


def _check(flushes, tmp_path, need_skip=False, need_bytes=True):
    assert flushes
    skipped = written = 0
    for k, f in enumerate(flushes):
        (p1, p2, ret, ppos, phw, pstats, pfill), \
            (r1, r2, _, rpos, rhw, rstats, rfill) = _flush_both(f, tmp_path, k)
        assert p1 == r1 and p2 == r2, k
        assert ret == len(p1) + len(p2) == pstats["stdout_bytes"], k
        np.testing.assert_array_equal(ppos, rpos)
        np.testing.assert_array_equal(phw, rhw)
        assert pstats == rstats, k
        np.testing.assert_array_equal(pfill, rfill)
        skipped += int(np.minimum(np.maximum(f.hw - f.pos, 0),
                                  ppos - f.pos).sum())
        written += len(p1) + len(p2)
    assert (written > 0) == need_bytes
    if need_skip:
        assert skipped > 0, "no flush skipped a replayed head"


@pytest.mark.parametrize("sw", [2048, 16])
def test_echo(sw, recorded, tmp_path):
    """Echo to its end (one flush), and with a 16-word buffer that fills:
    a write that does not fit parks, and a flush precedes each serve
    round."""
    _run_vm(build_echo(), "echo", [np.arange(LANES) % 4 + 1], 48, tmp_path,
            sw)
    assert (len(recorded) > 1) == (sw == 16)
    _check(recorded, tmp_path)


def test_hello(recorded, tmp_path):
    """hello's one fd_write has three iovecs, which tier 0 leaves to the
    host: its flushes find no record, and neither package writes."""
    _run_vm(build_wasi_hello(), "hello", [np.arange(LANES) % 3], 64,
            tmp_path)
    assert (tmp_path / "run.1").read_bytes().count(b"hello ") == LANES
    _check(recorded, tmp_path, need_bytes=False)


@pytest.mark.parametrize("case", ["digit", "digit_fd3"])
def test_zoo_mixed_lanes(case, recorded, tmp_path):
    func, args = tier0_cases(LANES, SEED)[case]
    _run_vm(build_tier0_zoo(), func, args, 64, tmp_path)
    fds, lens = set(), set()
    for f in recorded:
        for lane in range(f.so_off.shape[0]):
            off = 0
            while off < f.so_off[lane]:
                hdr = int(np.uint32(f.so_buf[off, lane]))
                fds.add(hdr >> 28)
                lens.add((hdr & 0x0FFFFFFF) % 4)
                off += 1 + ((hdr & 0x0FFFFFFF) + 3) // 4
    # both fds, and lengths that are not whole words
    assert {1, 2} <= fds and lens - {0}
    _check(recorded, tmp_path)


@pytest.mark.parametrize("compact", [False, True])
def test_restored_run_skips_a_replay(compact, recorded, tmp_path):
    (ref, _), (port, _) = cursor._engines(tmp_path, compact=compact)
    cursor._drive(port, "port", tmp_path / "port.npz", cursor.CHUNK,
                  3 * cursor.CHUNK)
    _check(recorded, tmp_path, need_skip=True)


def test_random_planes(tmp_path):
    _check(_random_flushes(np.random.default_rng(SEED), 12), tmp_path,
           need_skip=True)


def _norm(per_fd):
    return {fd: bytes(b) for fd, b in per_fd.items() if len(b)}


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(recorded, tmp_path):
    """On the card: the flush kernel against `_records` on the recorded
    inputs of every run above and on random planes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flush kernel has no CPU mode")
    from wasmedge_tpu_torch.batch import stdout_flush

    for sw in (2048, 16):
        _run_vm(build_echo(), "echo", [np.arange(LANES) % 4 + 1], 48,
                tmp_path, sw)
    func, args = tier0_cases(LANES, SEED)["digit"]
    _run_vm(build_tier0_zoo(), func, args, 64, tmp_path)
    for compact in (False, True):
        (_, _), (port, _) = cursor._engines(tmp_path, compact=compact)
        cursor._drive(port, "port", tmp_path / f"port{compact}.npz",
                      cursor.CHUNK, 3 * cursor.CHUNK)
    for f in list(recorded) + _random_flushes(np.random.default_rng(1), 12):
        skip = np.maximum(f.hw - f.pos, 0)
        got = stdout_flush.records(torch.from_numpy(f.so_buf).cuda(),
                                   torch.from_numpy(f.so_off).cuda(), skip)
        rows = int(f.so_off.max(initial=0))
        if rows == 0:
            assert got is None
            continue
        want, lens = hostcall._records(f.so_buf[:rows], f.so_off, skip)
        assert _norm(got[0]) == _norm(want)
        np.testing.assert_array_equal(got[1], lens)
