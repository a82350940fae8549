"""The exactly-once stdout cursor (ROADMAP C11) on the port against the
JAX package.

A tier-0 echo batch (fd_write retired in the kernel, its records
buffered per lane) is driven to a launch boundary, checkpointed, driven
on (its records flushed to the fd), restored from the checkpoint and
finished.  Each package writes the records flushed after the snapshot
once: the replay below the engine's high-water mark is skipped.  The
bytes each package writes to its fd are equal, every record appears
once (the uninterrupted run's byte count), and the checkpoints'
`stdout_pos` arrays are equal; a replay from the initial state after a
cursor reset that keeps the high-water mark prints nothing more.  With
lane compaction forced on, the cursor moves with the lanes through each
permutation, after the restore too: the port prints each record once,
and so does the JAX package unless a lane moved between the snapshot
and the restore (ROADMAP C12: its `load` leaves the written marks where
the lanes left them).  Plain versions on the CPU; exact.
"""

import numpy as np
import pytest

from wasmedge_tpu.batch import checkpoint as ref_checkpoint
from wasmedge_tpu.batch.compact import arm as ref_arm
from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.batch.hostcall import stdout_cursor_reset as ref_reset
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu_torch.batch import checkpoint
from wasmedge_tpu_torch.batch.compact import arm
from wasmedge_tpu_torch.batch.engine import BatchEngine
from wasmedge_tpu_torch.batch.hostcall import (
    _records, _stdout_cursor, stdout_cursor_reset)
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.models import build_echo
from wasmedge_tpu_torch.models.fixtures import COMPACT_FORCED
from wasmedge_tpu_torch.models.programs import ECHO_MESSAGE
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_tier0 import _Outs, _knobs, _wasi
from tests.test_torch_multitenant import inst_of

LANES, CHUNK, SW = 40, 48, 256
ITERS = (3 + np.arange(LANES) % 4).astype(np.int64)
# the records one lane writes: two fd_writes of the message an iteration
RECORD = 16


def _engines(tmp_path, compact=False):
    """(JAX engine, port engine) with tier 0 on and each package's own
    stdout file (fd 1); `compact`: lane compaction forced on
    (COMPACT_FORCED) and a compactor armed on each."""
    ref_outs, port_outs = _Outs(tmp_path, "ref"), _Outs(tmp_path, "port")
    rconf = RefConfigure()
    _knobs(rconf.batch, CHUNK, SW)
    rconf.batch.fuse_superinstructions = False
    rconf.batch.tierup = False
    conf = Configure()
    _knobs(conf.batch, CHUNK, SW)
    for k, v in (COMPACT_FORCED if compact else {}).items():
        setattr(rconf.batch, k, v)
        setattr(conf.batch, k, v)
    _, store, inst = ref_instantiate(build_echo(), rconf,
                                     imports=[_wasi("ref", ref_outs.fds)])
    ref = RefEngine(inst, store=store, conf=rconf, lanes=LANES)
    pinst, pstore = inst_of("port", build_echo(), conf,
                            imports=[_wasi("port", port_outs.fds)])
    port = BatchEngine(pinst, store=pstore, conf=conf, lanes=LANES,
                       device="cpu")
    if compact:
        ref_arm(ref)
        arm(port)
    return (ref, ref_outs), (port, port_outs)


def _drive(eng, pkg, path, first, second):
    """Run to `first` steps, save, run to `second` (flushing), restore
    and finish; returns the journaled stdout_pos and, per lane, the
    bytes the restore replays below the high-water mark."""
    save, load = (ref_checkpoint.save, ref_checkpoint.load) \
        if pkg == "ref" else (checkpoint.save, checkpoint.load)
    (ref_reset if pkg == "ref" else stdout_cursor_reset)(eng)
    st = eng.initial_state(eng.export_func_idx("echo"), [ITERS])
    st, total = eng.run_from_state(st, 0, first)
    assert (np.asarray(st.trap) == 0).any()   # in flight
    save(path, eng, st, total)
    _, total2 = eng.run_from_state(st, total, second)
    assert total2 > total
    st, total = load(path, eng)
    pos, hw = _stdout_cursor(eng, LANES) if pkg == "port" else \
        eng._stdout_cursor
    replay = np.array(hw) - np.array(pos)
    comp = getattr(eng, "compactor", None)
    fires = None if comp is None else comp.stats["fires"]
    st, total = eng.run_from_state(st, total, 10_000)
    if comp is not None:
        # the lanes moved after the restore, with records still to skip
        assert comp.stats["fires"] > fires and (replay > 0).any()
    assert not (np.asarray(st.trap) == 0).any()
    with np.load(path, allow_pickle=False) as z:
        return np.asarray(z["stdout_pos"]), replay


@pytest.mark.parametrize("first,second", [(CHUNK, 3 * CHUNK),
                                          (2 * CHUNK, 4 * CHUNK)])
def test_restore_after_flush_prints_each_record_once(first, second,
                                                     tmp_path):
    (ref, ref_outs), (port, port_outs) = _engines(tmp_path)
    ref_pos, ref_replay = _drive(ref, "ref", tmp_path / "ref.npz", first,
                                 second)
    pos, replay = _drive(port, "port", tmp_path / "port.npz", first,
                         second)
    np.testing.assert_array_equal(pos, ref_pos)
    np.testing.assert_array_equal(replay, ref_replay)
    assert (replay > 0).any()   # the restore replays flushed records
    got, want = port_outs.read()[0], ref_outs.read()[0]
    assert got == want
    # every record once: two messages an iteration, lane by lane
    assert len(got) == int(2 * ITERS.sum()) * RECORD
    assert got.count(bytes(ECHO_MESSAGE)) == int(2 * ITERS.sum())
    assert port.hostcall_stats["stdout_bytes"] == len(got)


@pytest.mark.parametrize("first,second,twice", [(CHUNK, 3 * CHUNK, 0),
                                                (2 * CHUNK, 4 * CHUNK, 46)])
def test_compacted_restore_prints_each_record_once(first, second, twice,
                                                   tmp_path):
    """A compacted echo batch saved, run on past a permutation, restored
    and finished: the cursor moves with its lanes (`LaneCompactor.
    permute_state`, `checkpoint.load`).  The journaled `stdout_pos`
    equals the JAX package's and the port prints every record once.
    The JAX package prints the same bytes where no lane moved between
    the snapshot and the restore, and `twice` records again where lanes
    did (ROADMAP C12)."""
    (ref, ref_outs), (port, port_outs) = _engines(tmp_path, compact=True)
    ref_pos, ref_replay = _drive(ref, "ref", tmp_path / "ref.npz", first,
                                 second)
    pos, replay = _drive(port, "port", tmp_path / "port.npz", first,
                         second)
    np.testing.assert_array_equal(pos, ref_pos)
    got, want = port_outs.read()[0], ref_outs.read()[0]
    n = int(2 * ITERS.sum())
    assert len(got) == n * RECORD
    assert got.count(bytes(ECHO_MESSAGE)) == n
    assert port.hostcall_stats["stdout_bytes"] == len(got)
    assert want.count(bytes(ECHO_MESSAGE)) == n + twice
    if not twice:
        assert got == want
        np.testing.assert_array_equal(replay, ref_replay)
    for eng in (ref, port):
        assert eng.compactor.stats["moved_lanes"] > 0


def test_checkpoint_stdout_pos_equals_jax(tmp_path):
    """A snapshot before any flush journals zeros in both packages, and
    one after a flush each lane's position."""
    (ref, _), (port, _) = _engines(tmp_path)
    for pkg, eng, save in (("ref", ref, ref_checkpoint.save),
                           ("port", port, checkpoint.save)):
        st = eng.initial_state(eng.export_func_idx("echo"), [ITERS])
        save(tmp_path / f"{pkg}0.npz", eng, st, 0)
        st, total = eng.run_from_state(st, 0, 2 * CHUNK)
        save(tmp_path / f"{pkg}1.npz", eng, st, total)
    for k in (0, 1):
        with np.load(tmp_path / f"ref{k}.npz") as r, \
                np.load(tmp_path / f"port{k}.npz") as p:
            np.testing.assert_array_equal(p["stdout_pos"], r["stdout_pos"])
            assert (p["stdout_pos"] > 0).any() == (k == 1)


@pytest.mark.parametrize("keep", [True, False])
def test_replay_from_the_start(keep, tmp_path):
    """A finished run replayed from its initial state after
    `stdout_cursor_reset(eng, keep_highwater=keep)` prints nothing more
    (keep) or every record again (a new stream), as in the JAX
    package."""
    (ref, ref_outs), (port, port_outs) = _engines(tmp_path)
    for eng, reset in ((ref, ref_reset), (port, stdout_cursor_reset)):
        reset(eng)
        for k in range(2):
            if k:
                reset(eng, keep_highwater=keep)
            st = eng.initial_state(eng.export_func_idx("echo"), [ITERS])
            eng.run_from_state(st, 0, 10_000)
    got, want = port_outs.read()[0], ref_outs.read()[0]
    assert got == want
    assert len(got) == (1 if keep else 2) * int(2 * ITERS.sum()) * RECORD


def test_records_skip_a_replayed_head():
    """The record parser leaves out each lane's first `skip` payload
    bytes across its records, and counts every record's bytes."""
    L, SW2 = 4, 16
    buf = np.zeros((SW2, L), np.int32)
    so_off = np.zeros(L, np.int32)
    stream = {}
    for lane in range(L):
        for ln in (5, 3):
            data = bytes((lane * 16 + ln + i) & 0xFF for i in range(ln))
            off = int(so_off[lane])
            buf[off, lane] = ln | (1 << 28)
            nw = (ln + 3) // 4
            buf[off + 1:off + 1 + nw, lane] = np.frombuffer(
                data + b"\0" * (4 * nw - ln), np.int32)
            so_off[lane] = off + 1 + nw
            stream[lane] = stream.get(lane, b"") + data
    skip = np.array([0, 2, 5, 8], np.int64)
    out, lens = _records(buf, so_off, skip)
    assert lens.tolist() == [8] * L
    assert out == {1: b"".join(stream[k][skip[k]:] for k in range(L))}
    full, _ = _records(buf, so_off)
    assert full == {1: b"".join(stream[k] for k in range(L))}
