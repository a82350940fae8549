"""chip_smoke.py's lane-compaction phases alone, on one GPU.

Run from the root of a checkout:  python3 tools/compact_probe.py
                                  python3 tools/compact_probe.py --serve-turns

Builds only what they need (fib, the CoreMark-style kernel, config 5's
straddling image and its tenants, the per-op libraries), then runs
compact_jobs (narrowed launches and a launch after a permutation, kernel
against plain), the divergent fib mix uncompacted and through
phase_compact_fib_mix, the straddling mix uncompacted (mix_case) and
compacted, serving uncompacted, compacted and compacted under the
profiler, and the checkpoint round trips; the last line is one JSON
object of the records.  With --serve-turns: only the serving run, with
compaction off, on, on, off in one process, each round's host phases
(admission, the compaction round, the launch slice, kills, harvest) timed
apart.  Exits non-zero without a CUDA device.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def serve_turns():
    """The serving run off, on, on, off, with the server's phases timed."""
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.serve import BatchServer

    interp.build_kernels([cs.mix_engine(cs.config5_specs(
        cs.STRADDLE_LANES, cs.STRADDLE_N), device="cpu").tables])
    spent = {}

    def timed(name, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return wrap

    for name in ("_admit", "_compact_round", "_enforce", "_harvest",
                 "_expire_queued"):
        setattr(BatchServer, name, timed(name, getattr(BatchServer, name)))
    orig_init = BatchServer.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        self.engine.run_slice = timed("run_slice", self.engine.run_slice)

    BatchServer.__init__ = init
    out = []
    for compact in (False, True, True, False):
        spent.clear()
        rec = cs.serve_once(False, compact=compact)
        rec["phases_s"] = dict(spent)
        out.append(rec)
        print(f"  serving, compaction {'on' if compact else 'off'}: wall "
              f"{rec['wall_s']:.3f} s, {rec['requests_per_s']:.1f} req/s, "
              f"p50 {rec['latency_p50_ms']:.1f} ms, p99 "
              f"{rec['latency_p99_ms']:.1f} ms, events {rec['event_ms']:.1f}"
              f" ms; host phases "
              f"{ {k: round(v, 4) for k, v in spent.items()} }", flush=True)
    print("compact_probe ok", flush=True)
    print(json.dumps(out, default=str), flush=True)


def main():
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.models import build_coremark_kernel, build_fib
    from wasmedge_tpu_torch.vm.vm import VM

    import torch

    if not torch.cuda.is_available():
        print("compact_probe: no CUDA device", flush=True)
        sys.exit(2)
    print(cs.gpu_name_and_power(), flush=True)
    if "--serve-turns" in sys.argv:
        return serve_turns()
    t0 = time.perf_counter()
    tables = [cs.mix_engine(cs.config5_specs(cs.STRADDLE_LANES,
                                             cs.STRADDLE_N),
                            device="cpu").tables]
    tables += [t.engine.tables for t in cs.mix_tenants(
        cs.mix_conf(), cs.config5_specs(dict.fromkeys(cs.MIX_N, 2),
                                        cs.MIX_N), "cpu")]
    for opt in (None, False):
        tables.append(cs.make_engine(build_fib(), 2, device="cpu",
                                     fusion="blocks", optimistic=opt,
                                     value_stack_depth=256)[0].tables)
        for m in (True, False):
            tables.append(cs.make_engine(
                build_coremark_kernel(), 2, device="cpu", fusion="blocks",
                optimistic=opt, mem_hbm=m, value_stack_depth=256)[0].tables)
    interp.build_kernels(tables, per_op=[
        (w, o, False) for w in (False, True) for o in (False, True)])
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    w = cs.run_jobs({"compact": cs.compact_jobs()})
    print(f"jobs {time.perf_counter() - t0:.1f} s, worst {w}", flush=True)

    out = {}
    t0 = time.perf_counter()
    conf = Configure()
    conf.batch.lanes = cs.MAIN_LANES
    conf.batch.value_stack_depth = 256
    conf.batch.call_stack_depth = 256
    vm = VM(conf)
    vm.load_wasm(build_fib())
    vm.validate()
    vm.instantiate()
    ns = 20 + np.arange(cs.MAIN_LANES) % 11
    run = cs.run_main(vm, "fib", [ns], 1 << 20, ("interp", "block"))
    cs.UNCOMPACTED["fib_mix"] = [run[0]]
    retired = int(run[0].retired.astype(np.int64).sum())
    off = cs.report_main("fib mix, uncompacted", run, retired)
    off["profile"] = cs.profile_run(vm, "fib", [ns], retired)
    out["fib_mix_off"] = off
    out["fib_mix"] = cs.phase_compact_fib_mix()
    print(f"fib mix {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    out["straddle_off"] = cs.mix_case("straddling mix", cs.STRADDLE_LANES,
                                      cs.STRADDLE_N)
    out["straddle"] = cs.phase_compact_straddle()
    print(f"straddle {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    out["serve_off"] = cs.serve_once(False)
    out["serve"] = cs.serve_once(False, compact=True)
    out["serve_profiled"] = cs.serve_once(True, compact=True)
    for k in ("serve_off", "serve"):
        r = out[k]
        print(f"  {k}: rounds {r['rounds']}, wall {r['wall_s']:.3f} s, "
              f"{r['requests_per_s']:.1f} req/s, p50 "
              f"{r['latency_p50_ms']:.1f} ms, p99 {r['latency_p99_ms']:.1f} "
              f"ms, B3 {r['uniform']} / {r['entered']}, rollbacks "
              f"{r['rollbacks']}, compaction {json.dumps(r.get('compact'))}"
              f" {r.get('compact_round_ms')}", flush=True)
    print(f"  serve compacted, profiled: {out['serve_profiled']}",
          flush=True)
    print(f"serve {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    out["checkpoint"] = cs.phase_compact_checkpoint()
    print(f"checkpoint {time.perf_counter() - t0:.1f} s", flush=True)
    print("compact_probe ok", flush=True)
    print(json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
    main()
