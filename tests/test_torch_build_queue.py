"""The kernel builds' queue (`batch/interp.py` `start_builds` /
`build_kernels`) on the CPU, with a stand-in for nvcc: builds queued for
the background run at most `at_once` at a time and at the lowest CPU
priority, `build_kernels` starts a queued build at once and waits for a
running one, records each build, and raises when one fails."""

import os
import stat
import sys

import pytest

from wasmedge_tpu_torch.batch import interp

# writes an empty library, and a line for its start (pid, time, niceness,
# defines) and its end to FAKE_NVCC_LOG; fails when an argument holds
# FAKE_NVCC_FAIL's text
FAKE_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
log = os.environ["FAKE_NVCC_LOG"]
with open(log, "a") as f:
    f.write(f"start {{os.getpid()}} {{time.time()}} {{os.nice(0)}} "
            f"{{' '.join(a for a in args if a.startswith('-D'))}}\\n")
time.sleep(0.3)
bad = os.environ.get("FAKE_NVCC_FAIL")
if bad and any(bad in a for a in args):
    print("ptxas fatal   : a stand-in failure")
    sys.exit(2)
open(out, "wb").close()
print("ptxas info    : Used 10 registers")
with open(log, "a") as f:
    f.write(f"end {{os.getpid()}} {{time.time()}}\\n")
"""

# the (window, optimistic, split) triples of four per-op builds
TRIPLES = [(w, o, False) for w in (False, True) for o in (False, True)]


class _Lib:
    def __init__(self, path):
        self.path = path
        self.wasm_interp_launch = lambda *a: 0
        self.wasm_fused_launch = lambda *a: 0


@pytest.fixture
def fake(tmp_path, monkeypatch):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.delenv("FAKE_NVCC_FAIL", raising=False)
    monkeypatch.setattr(interp, "_BUILD_DIR", str(tmp_path / "_build"))
    for name in ("_libs", "_jobs", "_running", "_queued"):
        monkeypatch.setattr(interp, name, {})
    monkeypatch.setattr(interp, "BUILD_INFO",
                        {"fused": {}, "per_op": {}, "waited": {}})
    monkeypatch.setattr(interp.ctypes, "CDLL", _Lib)
    yield log
    interp._stop_builds()


def runs(log):
    """{pid: [start, end or None, niceness, defines]} from the log."""
    out = {}
    for line in log.read_text().splitlines():
        kind, pid, t, *rest = line.split(" ")
        if kind == "start":
            out[pid] = [float(t), None, int(rest[0]), " ".join(rest[1:])]
        else:
            out[pid][1] = float(t)
    return out


def most_at_once(spans) -> int:
    events = sorted([(s, 1) for s, e in spans] + [(e, -1) for s, e in spans],
                    key=lambda x: (x[0], x[1]))
    now = best = 0
    for _, d in events:
        now += d
        best = max(best, now)
    return best


def test_background_builds_run_at_most_at_once_and_niced(fake):
    assert interp.start_builds(per_op=TRIPLES, at_once=1) == 4
    # queued twice: nothing more
    assert interp.start_builds(per_op=TRIPLES, at_once=1) == 0
    # two of the 0.3 s builds, one after the other, in the background
    # (waited for by their log lines, not by the clock: a loaded host
    # starts the stand-in slowly)
    for _ in range(3000):
        if fake.exists() and fake.read_text().count("end ") >= 2:
            break
        interp.time.sleep(0.01)
    libs = interp.build_kernels(per_op=TRIPLES)
    assert len(libs) == 4
    got = runs(fake)
    assert len(got) == 4 and all(e is not None for _, e, _, _ in
                                 got.values())
    background = [r for r in got.values() if r[2] > 0]
    # the builds still queued when build_kernels came were started by it
    # in the foreground, the others in the background, niced and one at
    # a time
    assert len(background) >= 2
    assert most_at_once([(s, e) for s, e, _, _ in background]) == 1
    started_bg = [v for v in interp.BUILD_INFO["per_op"].values()
                  if v["background"]]
    assert len(background) == (len(started_bg) if interp.shutil.which(
        "nice") else 0)
    for label in (interp.per_op_label(*t) for t in TRIPLES):
        info = interp.BUILD_INFO["per_op"][label]
        assert os.path.exists(info["path"])
        assert info["seconds"] > 0 and "Used 10 registers" in info["ptxas"]
    # built: nothing is queued or run again
    assert interp.start_builds(per_op=TRIPLES) == 0
    assert interp.build_kernels(per_op=TRIPLES).keys() == libs.keys()
    assert len(runs(fake)) == 4


def test_build_kernels_waits_for_a_running_background_build(fake):
    one = [(True, True, False)]
    assert interp.start_builds(per_op=one, at_once=1) == 1
    # the reaper starts it in the background within a poll
    for _ in range(100):
        if interp._running:
            break
        interp.time.sleep(0.01)
    assert len(interp._running) == 1
    interp.build_kernels(per_op=one)
    key = interp._job(None, *one[0], None)[0]
    assert list(interp.BUILD_INFO["waited"]) == [key]
    assert interp.BUILD_INFO["per_op"][
        interp.per_op_label(*one[0])]["background"] is True
    assert not interp._running and not interp._queued


def test_a_failed_background_build_raises_when_taken(fake, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "-DWASM_MEM_WINDOW=1")
    interp.start_builds(per_op=TRIPLES, at_once=4)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        interp.build_kernels(per_op=TRIPLES)
