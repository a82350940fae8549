"""Tier-0 host calls on the port against the JAX package.

Pure WASI calls (clock_time_get, random_get, sched_yield, proc_exit and
fd_write to fd 1 or 2) retire inside the interpreter when
`tier0_hostcalls` is on, the default in both packages.  Checks:

  - `batch/tier0.py` function by function against
    `wasmedge_tpu.batch.tier0` on random int32 inputs (lane index
    0x7FFFFFFF and seeds with the top bit set included);
  - per launch: the reference's image and initial state are carried into
    the port, the reference SIMT `BatchEngine.run_from_state` (tier 0 on,
    a fixed `rng_seed`, `t0_time_planes` pinned, superinstruction fusion
    and tier-up off) and the port's plain engine (the same seed, its own
    `t0_time_planes` pinned to the same time base) each make one launch,
    its serve round and its stdout flush per call, and every plane
    (`t0_ctr`, `so_buf` and `so_off` included) must be bit-identical
    after every call (the stack's rows below sp where a fused dispatch or
    a rollback leaves dead rows above), with `optimistic` on and off,
    `mem_hbm` on and off,
    per-op, in B2 blocks and in B6 superinstructions; each package's
    stdout (fd 1 and fd 2, each its own file) byte for byte;
  - stdout against the scalar oracle (one fresh instance per lane) where
    no random or clock value reaches it and no call parks;
  - B3 with tier 0: a uniform warp that calls random_get gets per-lane
    bytes (equal to the reference's) and leaves "on" at the call;
  - the flush's record parser, and the knobs' defaults.

The reference trajectory of each case is computed once and replayed
against every port configuration.
"""

import os
import time

import numpy as np
import pytest
import torch

import wasmedge_tpu.batch.engine as ref_engine_mod
from wasmedge_tpu.batch.hostcall import stdout_cursor_reset
from wasmedge_tpu.batch import tier0 as R
from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import TrapError as RefTrapError
from wasmedge_tpu.host.wasi import WasiExit as RefWasiExit
from wasmedge_tpu.host.wasi import WasiModule as RefWasiModule
import wasmedge_tpu_torch.batch.engine as port_engine_mod
from wasmedge_tpu_torch.batch import tier0 as P
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import (
    BatchEngine, mem_window_of, optimistic_of, t0_effective_kinds)
from wasmedge_tpu_torch.batch.hostcall import stdout_bytes
from wasmedge_tpu_torch.batch.image import (
    T0_CLOCK_TIME_GET, T0_FD_WRITE, T0_NONE, TRAP_HOSTCALL)
from wasmedge_tpu_torch.batch.interp import device_tables
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.common.configure import BatchConfigure, Configure
from wasmedge_tpu_torch.executor.instantiate import (
    instantiate, register_import_object)
from wasmedge_tpu_torch.host.wasi import WasiModule
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import build_echo, build_wasi_hello
from wasmedge_tpu_torch.models.fixtures import (
    build_tier0_unsafe, build_tier0_zoo, tier0_cases)
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.validator import Validator
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_interp import _assert_planes, _image_of, _ref_planes

CHUNK = 64
D, CD = 64, 16
LANES = 40  # a whole warp and a part of one
SEED = 20261018
RNG_SEED = 0x8BADF00D  # the top bit set
# the launches' pinned time base: realtime and monotonic ns as (lo, hi)
TT = np.array([[-123456789, 0x179F], [0x7FFFFFF0, 0x2A]], np.int32)
WASI_ARGS = ["alpha", "be"]
CASES = tier0_cases(LANES, SEED)
# case -> (module, export, args, lanes, steps per launch, stdout words)
RUNS = {name: (build_tier0_zoo, func, args, LANES, CHUNK, 2048)
        for name, (func, args) in CASES.items()}
RUNS["uniform"] = (build_tier0_zoo, "uniform", [np.full(64, 700)], 64,
                   CHUNK, 2048)
RUNS["digit_full"] = (build_tier0_zoo, "digit",
                      [np.arange(LANES), np.full(LANES, 8),
                       np.ones(LANES, np.int64)], LANES, 256, 16)
RUNS["unsafe"] = (build_tier0_unsafe, "f", [np.arange(LANES)], LANES,
                  CHUNK, 2048)
RUNS["echo"] = (build_echo, "echo", [np.full(LANES, 2)], LANES, CHUNK, 2048)
RUNS["hello"] = (build_wasi_hello, "hello", [np.arange(LANES) % 3], LANES,
                 CHUNK, 2048)

# the port configurations a case runs in: (fusion, optimistic, mem_hbm);
# per-op in all four B3 and memory modes, and the cases that reach every
# handler in blocks and super in two each
PER_OP = [("none", o, m) for o in (None, False) for m in (None, False)]
FUSED = [("blocks", None, None), ("blocks", False, False),
         ("super", None, False), ("super", False, None)]
FUSED_CASES = ("clock", "random", "digit", "digit_full", "shapes", "uniform",
               "echo")
PARAMS = [(name, *cfg) for name in RUNS
          for cfg in PER_OP + (FUSED if name in FUSED_CASES else [])]


@pytest.fixture(autouse=True)
def _host_entropy(monkeypatch):
    """What the host's WASI reads for the calls that park (the cputime
    clocks, ids 2 and 3, and random_get above tier0_random_max): one
    fixed reading and a fixed byte stream, the same for both packages."""
    monkeypatch.setattr(time, "process_time_ns", lambda: 0x1234_5678_9ABC)
    monkeypatch.setattr(time, "thread_time_ns", lambda: 0x0FED_CBA9_8765)
    monkeypatch.setattr(os, "urandom",
                        lambda n: bytes((37 * i + 11) & 0xFF
                                        for i in range(n)))


def _wasi(pkg, fds):
    wasi = RefWasiModule() if pkg == "ref" else WasiModule()
    wasi.init_wasi(args=list(WASI_ARGS))
    wasi.env.fds[1].os_fd, wasi.env.fds[2].os_fd = fds
    return wasi


class _Outs:
    """Two files, stdout and stderr, opened for one run."""

    def __init__(self, tmp_path, tag):
        self.paths = [tmp_path / f"{tag}.{k}" for k in (1, 2)]
        self.fds = tuple(os.open(p, os.O_RDWR | os.O_CREAT | os.O_TRUNC)
                         for p in self.paths)

    def read(self):
        for fd in self.fds:
            os.close(fd)
        return tuple(p.read_bytes() for p in self.paths)


def _knobs(b, chunk, sw):
    b.steps_per_launch = chunk
    b.value_stack_depth, b.call_stack_depth = D, CD
    b.memory_pages_per_lane = 1
    b.tier0_hostcalls = True
    b.rng_seed = RNG_SEED
    b.stdout_buffer_words = sw


_TRAJ = {}
_REF = {}


def _ref_engine(build, lanes, chunk, sw, tmp_path_factory):
    """One reference engine (and its stdout files) per module and
    geometry, shared by the cases that run on it: one compile."""
    key = (build, lanes, chunk, sw)
    if key not in _REF:
        conf = RefConfigure()
        _knobs(conf.batch, chunk, sw)
        conf.batch.fuse_superinstructions = False
        conf.batch.tierup = False
        outs = _Outs(tmp_path_factory.mktemp("ref"), "ref")
        _, store, inst = ref_instantiate(build(), conf,
                                         imports=[_wasi("ref", outs.fds)])
        _REF[key] = (RefEngine(inst, store=store, conf=conf, lanes=lanes),
                     outs)
    return _REF[key]


def _ref_trajectory(name, tmp_path_factory):
    """The reference run of case `name`, launch by launch: (image,
    initial planes, [(total, planes)] after each call, (fd 1, fd 2)
    bytes, hostcall stats of the run)."""
    if name in _TRAJ:
        return _TRAJ[name]
    build, func, args, lanes, chunk, sw = RUNS[name]
    ref, outs = _ref_engine(build, lanes, chunk, sw, tmp_path_factory)
    for fd in outs.fds:
        os.ftruncate(fd, 0)
        os.lseek(fd, 0, os.SEEK_SET)
    stdout_cursor_reset(ref)  # a new stream, not a replay of the last
    stats0 = dict(ref.hostcall_stats)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    start = _ref_planes(st)
    steps, total = [], 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_engine_mod, "t0_time_planes", lambda: TT.copy())
        for _ in range(400):
            st, total = ref.run_from_state(st, total, total + 1)
            steps.append((total, _ref_planes(st)))
            if not (np.asarray(st.trap) == 0).any():
                break
        else:
            raise AssertionError("reference still running after 400 calls")
    out = tuple(p.read_bytes() for p in outs.paths)
    stats = {k: v - stats0[k] for k, v in ref.hostcall_stats.items()
             if isinstance(v, int)}
    _TRAJ[name] = (ref.img, start, steps, out, stats)
    return _TRAJ[name]


def _port_engine(data, lanes, chunk, sw, fds, fusion="none", optimistic=None,
                 mem_hbm=None, tier0=True):
    conf = Configure()
    _knobs(conf.batch, chunk, sw)
    conf.batch.tier0_hostcalls = tier0
    conf.batch.optimistic, conf.batch.mem_hbm = optimistic, mem_hbm
    conf.batch.block_fusion = fusion == "blocks"
    store = StoreManager()
    register_import_object(store, _wasi("port", fds))
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    inst = instantiate(store, mod, conf)
    return BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                       device="cpu"), inst


def _port_replay(name, traj, tmp_path, monkeypatch, fusion, optimistic,
                 mem_hbm):
    """The port's plain engine from the reference's image and state, one
    launch and its serve round per call, every plane equal to the
    reference's after every call.  Returns (engine, state, stdout)."""
    build, func, args, lanes, chunk, sw = RUNS[name]
    img, start, steps, _, _ = traj
    outs = _Outs(tmp_path, f"port-{name}")
    eng, _ = _port_engine(build(), lanes, chunk, sw, outs.fds, fusion,
                          optimistic, mem_hbm)
    eng.img = _image_of(img)
    eng.t0kinds = t0_effective_kinds(eng.img, eng.cfg)
    eng.tables = device_tables(
        eng.img, "cpu", fusion, mem_window=mem_window_of(mem_hbm, eng.img),
        optimistic=optimistic_of(optimistic), stack_depth=D,
        t0kinds=eng.t0kinds, t0=P.t0_statics(eng.cfg))
    eng.warps = WarpState.new(lanes, "cpu") if eng.tables.optimistic \
        else None
    monkeypatch.setattr(port_engine_mod, "t0_time_planes", lambda: TT.copy())
    port = state_from_reference(start, device="cpu")
    total = 0
    for call, (want_total, want) in enumerate(steps):
        port, total = eng.run_from_state(port, total, total + 1)
        where = f"{name} [{fusion}, opt={optimistic}, hbm={mem_hbm}] " \
            f"call {call}"
        assert total == want_total, where
        got = port.to_numpy()
        # a fused dispatch, and lane 0's wrong path before a rollback,
        # leave dead stack rows at or above sp that the reference's step
        # writes otherwise; every other plane and row is compared
        if fusion == "none" and not eng.tables.optimistic:
            _assert_planes(got, want, where)
        else:
            assert_live_planes(got, want, where)
        assert not (got["trap"] == TRAP_HOSTCALL).any()
    return eng, port, outs.read()


@pytest.mark.parametrize("name,fusion,optimistic,mem_hbm", PARAMS)
def test_tier0_matches_simt_every_launch(name, fusion, optimistic, mem_hbm,
                                         tmp_path, tmp_path_factory,
                                         monkeypatch):
    traj = _ref_trajectory(name, tmp_path_factory)
    eng, port, out = _port_replay(name, traj, tmp_path, monkeypatch, fusion,
                                  optimistic, mem_hbm)
    assert out == traj[3]
    ref_stats, stats = traj[4], eng.hostcall_stats
    for k in ("tier0_clock", "tier0_random", "tier0_fd_write", "tier0_sys",
              "tier0_calls", "tier1_calls", "serve_rounds", "stdout_bytes"):
        assert stats[k] == ref_stats[k], k
    if eng.tables.optimistic:
        w = eng.warps
        assert int(w.rollbacks.sum()) <= int(w.entered.sum())


# -- batch/tier0.py against wasmedge_tpu.batch.tier0 --------------------------

def _ints(rng, n):
    x = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, 0x7FFFFFFF, -2**31]
    return x


@pytest.mark.parametrize("seed", [0, 1, 0x80000001, 0xFFFFFFFF, 20261018])
def test_prng_and_seed_hash_match_reference(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    x = _ints(rng, 2000)
    assert (np.asarray(R.t0_prng32(jnp.asarray(x)))
            == P.t0_prng32(torch.as_tensor(x)).numpy()).all()
    for j in range(70):
        assert int(R.t0_word_mix(j)) == P.t0_word_mix(j)
    lane = rng.integers(0, 2**31, 2000).astype(np.int32)
    lane[:2] = [0x7FFFFFFF, 0]
    ctr = _ints(rng, 2000)
    sd = np.array(seed & 0xFFFFFFFF, np.uint32).view(np.int32)
    want = np.asarray(R.t0_rng_seq_hash(jnp.asarray(sd), jnp.asarray(lane),
                                        jnp.asarray(ctr)))
    got = P.t0_rng_seq_hash(int(sd), torch.as_tensor(lane),
                            torch.as_tensor(ctr)).numpy()
    assert (got == want).all()
    cid = rng.integers(-1, 5, 2000).astype(np.int32)
    tt = _ints(rng, 4).reshape(2, 2)
    want = R.t0_clock_value(jnp.asarray(tt), jnp.asarray(cid),
                            jnp.asarray(ctr))
    got = P.t0_clock_value(tt, torch.as_tensor(cid), torch.as_tensor(ctr))
    for w, g in zip(want, got):
        assert (np.asarray(w) == g.numpy()).all()


def _ref_prims():
    import jax.numpy as jnp

    def gather(plane, idx):
        idx = jnp.clip(idx, 0, plane.shape[0] - 1)
        return jnp.take_along_axis(plane, idx[None, :], axis=0)[0]

    def rmw(plane, idx, m, v, ok):
        idx = jnp.clip(idx, 0, plane.shape[0] - 1)
        cur = gather(plane, idx)
        new = jnp.where(ok & (m != 0), (cur & ~m) | (v & m), cur)
        return plane.at[idx, jnp.arange(plane.shape[1])].set(new)

    return gather, rmw


def _port_prims():
    def gather(plane, idx):
        idx = idx.long().clamp(0, plane.shape[0] - 1)
        return plane[idx, torch.arange(plane.shape[1])]

    def rmw(plane, idx, m, v, ok):
        idx = idx.long().clamp(0, plane.shape[0] - 1)
        lanes = torch.arange(plane.shape[1])
        cur = plane[idx, lanes]
        plane[idx, lanes] = torch.where(ok & (m != 0), (cur & ~m) | (v & m),
                                        cur)
        return plane

    return gather, rmw


@pytest.mark.parametrize("seed", [3, 4])
def test_stores_fill_and_source_words_match_reference(seed):
    """t0_masked_store (4 and 8 bytes), t0_random_fill and
    t0_shifted_src_word on a random [W, L] plane at every byte offset,
    with rows clamped at the plane's end."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    W, L = 48, 64
    plane = _ints(rng, W * L).reshape(W, L)
    ea = rng.integers(0, W * 4 - 4, L).astype(np.int32)
    ea[:4] = [0, 1, 2, W * 4 - 5]
    v_lo, v_hi = _ints(rng, L), _ints(rng, L)
    ok = rng.random(L) < 0.8
    rg, rr = _ref_prims()
    pg, pr = _port_prims()
    for nbytes in (4, 8):
        want = R.t0_masked_store(rr, jnp.asarray(plane), jnp.asarray(ea),
                                 jnp.asarray(v_lo), jnp.asarray(v_hi),
                                 nbytes, jnp.asarray(ok))
        got = P.t0_masked_store(pr, torch.as_tensor(plane.copy()),
                                torch.as_tensor(ea), torch.as_tensor(v_lo),
                                torch.as_tensor(v_hi), nbytes,
                                torch.as_tensor(ok))
        assert (np.asarray(want) == got.numpy()).all(), nbytes
    rbuf = rng.integers(0, 60, L).astype(np.int32)
    rlen = rng.integers(0, 65, L).astype(np.int32)
    rend = rbuf + rlen
    seq = _ints(rng, L)
    zero = np.zeros(L, np.int32)
    want = R.t0_random_fill(rr, jnp.asarray(plane), jnp.asarray(rbuf),
                            jnp.asarray(rend), jnp.asarray(ok),
                            jnp.asarray(seq), 16, jnp.asarray(zero))
    got = P.t0_random_fill(pr, torch.as_tensor(plane.copy()),
                           torch.as_tensor(rbuf), torch.as_tensor(rend),
                           torch.as_tensor(ok), torch.as_tensor(seq), 16,
                           torch.as_tensor(zero))
    assert (np.asarray(want) == got.numpy()).all()
    shb = (rbuf & 3) * 8
    inv = (32 - shb) & 31
    hi_or = np.where(shb == 0, 0, -1).astype(np.int32)
    w0 = rbuf >> 2
    for j in (0, 5, 20):
        want = R.t0_shifted_src_word(rg, jnp.asarray(plane), jnp.asarray(w0),
                                     j, jnp.asarray(shb), jnp.asarray(inv),
                                     jnp.asarray(hi_or))
        got = P.t0_shifted_src_word(pg, torch.as_tensor(plane),
                                    torch.as_tensor(w0), j,
                                    torch.as_tensor(shb),
                                    torch.as_tensor(inv),
                                    torch.as_tensor(hi_or))
        assert (np.asarray(want) == got.numpy()).all(), j


def test_statics_match_reference():
    ref, port = RefConfigure().batch, BatchConfigure()
    for seed in (None, 7, 0xDEADBEEF):
        ref.rng_seed = port.rng_seed = seed
        if seed is None:
            ref._rng_seed_drawn = port._rng_seed_drawn = 0x9000_0001
        want, got = R.t0_statics(ref), P.t0_statics(port)
        assert {k: int(v) for k, v in want.items()} == got
    # drawn once per configuration when no seed is given
    fresh = BatchConfigure()
    assert P.t0_statics(fresh)["RNG_SEED"] == \
        P.t0_statics(fresh)["RNG_SEED"]


# -- what the per-launch runs must show ---------------------------------------

def test_cases_reach_every_outcome(tmp_path_factory):
    """The reference runs themselves: each case serves what it is meant
    to serve in place and parks what it is meant to park."""
    def stats(name):
        return _ref_trajectory(name, tmp_path_factory)[4]

    s = stats("clock")
    assert s["tier0_clock"] > 0 and s["tier1_calls"] > 0  # cputime parks
    s = stats("random")
    assert s["tier0_random"] > 0 and s["tier1_calls"] > 0  # 65 bytes park
    assert stats("yield")["tier0_sys"] == int(np.sum(CASES["yield"][1][0]))
    assert stats("exit")["tier0_sys"] == LANES // 3
    s = stats("digit")
    assert s["tier0_fd_write"] == int(np.sum(CASES["digit"][1][1]))
    assert s["serve_rounds"] == 0 and s["stdout_flushes"] > 0
    s = stats("digit_fd3")
    assert s["tier0_fd_write"] > 0 and s["tier1_calls"] > 0
    s = stats("digit_full")
    assert s["tier0_fd_write"] > 0 and s["serve_rounds"] > 0
    s = stats("shapes")
    assert s["tier0_fd_write"] == LANES and s["tier1_calls"] > 0
    s = stats("unsafe")
    assert s["tier0_clock"] == LANES and s["tier0_fd_write"] == 0
    assert s["tier1_calls"] == LANES
    s = stats("echo")
    assert s["tier0_fd_write"] == 4 * LANES and s["serve_rounds"] == 0
    s = stats("hello")  # args_*, a three-iovec fd_write; proc_exit in place
    assert s["tier0_sys"] == LANES and s["tier1_calls"] == 3 * LANES


def test_unsafe_fd_write_parks_and_clock_is_served():
    img = _port_engine(build_tier0_unsafe(), 2, CHUNK, 2048, (1, 2))[0].img
    assert not img.t0_fdwrite_safe
    kinds = t0_effective_kinds(img, BatchConfigure())
    assert sorted(set(kinds.tolist())) == [T0_NONE, T0_CLOCK_TIME_GET]
    assert (img.t0kind == T0_FD_WRITE).sum() == 1  # named, not served


def test_uniform_warps_draw_their_own_bytes(tmp_path, tmp_path_factory,
                                            monkeypatch):
    """64 lanes of one argument: both warps enter uniform, run the clock
    read and the write in place, commit at random_get and leave "on";
    no rollback; every lane's bytes its own (equal to the reference's:
    the replay compares every plane)."""
    traj = _ref_trajectory("uniform", tmp_path_factory)
    eng, port, _ = _port_replay("uniform", traj, tmp_path, monkeypatch,
                                "none", None, None)
    w = eng.warps
    assert int(w.uniform[0]) >= 1 and int(w.uniform[1]) >= 1
    assert int(w.rollbacks.sum()) == 0
    assert int(w.commits.sum()) >= 2
    res = port.stack_lo[0].numpy()
    assert np.unique(res).size == 64
    # 16 random bytes a lane: no two lanes drew the same
    words = port.mem[700 // 4:700 // 4 + 4].numpy().T
    assert len({w.tobytes() for w in words}) == 64


def _scalar_stdout(tmp_path, data, func, args, lanes):
    """The scalar oracle's fd 1 and fd 2, one fresh instance per lane."""
    outs = _Outs(tmp_path, "scalar")
    for lane in range(lanes):
        ex, store, inst = ref_instantiate(data, RefConfigure(),
                                          imports=[_wasi("ref", outs.fds)])
        try:
            ex.invoke(store, inst.find_func(func),
                      [int(a[lane]) for a in args])
        except (RefTrapError, RefWasiExit):
            pass
    return outs.read()


@pytest.mark.parametrize("name", ["digit", "echo"])
def test_stdout_matches_scalar(name, tmp_path):
    """Where no call parks and no random or clock value reaches stdout,
    a whole run's buffered records (one flush, at its end) come out lane
    after lane, as the scalar oracle writes them."""
    build, func, args, lanes, _, sw = RUNS[name]
    outs = _Outs(tmp_path, "port")
    eng, _ = _port_engine(build(), lanes, 4096, sw, outs.fds)
    res = eng.run(func, args)
    out = outs.read()
    assert eng.hostcall_stats["serve_rounds"] == 0
    assert eng.hostcall_stats["stdout_flushes"] == 1
    assert (res.trap == -1).all()
    assert out == _scalar_stdout(tmp_path, build(), func, args, lanes)


def test_vm_echo_tier0_on_and_off(tmp_path):
    """VM.execute_batch: with tier 0 (the default) every fd_write retires
    in the kernel and one flush writes stdout; off, every call is served
    between launches; the same bytes."""
    from wasmedge_tpu_torch.common.configure import HostRegistration
    from wasmedge_tpu_torch.models.programs import ECHO_MESSAGE
    from wasmedge_tpu_torch.vm.vm import VM

    for tier0 in (True, False):
        conf = Configure()
        conf.host_registrations.add(HostRegistration.Wasi)
        conf.batch.tier0_hostcalls = tier0
        vm = VM(conf)
        outs = _Outs(tmp_path, f"vm{tier0}")
        vm.wasi_module.init_wasi(args=["a"])
        vm.wasi_module.env.fds[1].os_fd = outs.fds[0]
        vm.load_wasm(build_echo())
        vm.validate()
        vm.instantiate()
        res = vm.execute_batch("echo", [3], lanes=8, device="cpu")
        out = outs.read()
        assert (res.trap == -1).all() and (res.results[0] == 0).all()
        assert out[0] == ECHO_MESSAGE * 48
        s = vm.last_engine.hostcall_stats
        assert s["tier0_fd_write"] == (48 if tier0 else 0)
        assert s["tier1_calls"] == (0 if tier0 else 48)
        assert s["stdout_flushes"] == (1 if tier0 else 0)
        assert s["stdout_bytes"] == (len(out[0]) if tier0 else 0)


def test_stdout_records_parse_alike_in_both_layouts():
    """The flush's parser: lanes with the same record layout are cut out
    all at once, others lane by lane; the bytes are the same, lane after
    lane and fd by fd."""
    rng = np.random.default_rng(5)
    L, SW = 6, 40
    buf = np.zeros((SW, L), np.int32)
    so_off = np.zeros(L, np.int32)
    want = {}
    for lane in range(L):
        for ln, fd in ((5, 1), (0, 2), (9, 1)) if lane != 3 else \
                ((2, 2), (13, 1)):
            data = bytes(rng.integers(0, 256, ln, dtype=np.uint8))
            off = int(so_off[lane])
            buf[off, lane] = ln | (fd << 28)
            nw = (ln + 3) // 4
            words = np.frombuffer(data + b"\0" * (4 * nw - ln), np.int32)
            buf[off + 1:off + 1 + nw, lane] = words
            so_off[lane] = off + 1 + nw
            want.setdefault(fd, {}).setdefault(lane, b"")
            want[fd][lane] += data
    got = stdout_bytes(buf, so_off)
    assert got == {fd: b"".join(v[k] for k in sorted(v))
                   for fd, v in want.items()}
    same = np.delete(np.arange(L), 3)
    sub = stdout_bytes(buf[:, same], so_off[same])
    assert sub == {fd: b"".join(v[k] for k in sorted(v) if k != 3)
                   for fd, v in want.items()}
