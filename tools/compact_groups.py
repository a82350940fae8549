"""Where lane compaction's time goes on the divergent fib mix, on one GPU.

Run from the root of a checkout:  python3 tools/compact_groups.py

The mix fib(20 + lane % 11) x 4096 (stacks 256, 2^20 steps a launch, B2
blocks, optimistic) through VM.execute_batch: uncompacted, with its
arguments pre-sorted (contiguous groups of one n, their edges inside
warps), warp-aligned (each warp one n), and compacted with and without
narrowing.  After every launch it records how many live warps hold lanes
of two or more n; each run is profiled (kernel device time).  Prints
chip_smoke.py's lines for each run and, last, one JSON line of the
records.  Exits non-zero without a CUDA device.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    from wasmedge_tpu_torch.batch import engine as E
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.models import build_fib
    from wasmedge_tpu_torch.vm.vm import VM

    import torch

    if not torch.cuda.is_available():
        print("compact_groups: no CUDA device", flush=True)
        sys.exit(2)
    print(cs.gpu_name_and_power(), flush=True)
    interp.build_kernels([cs.make_engine(build_fib(), 2, device="cpu",
                                         fusion="blocks",
                                         value_stack_depth=256)[0].tables])
    L = cs.MAIN_LANES
    base = 20 + np.arange(L) % 11
    log = []
    orig = E.BatchEngine._read_back

    def read_back(self, state, before, R):
        host, done = orig(self, state, before, R)
        src = np.arange(L) if self.compactor is None else self.compactor.src
        n = ARGS[0][src]
        live = host.trap == 0
        mixed = 0
        warps = 0
        worst = []
        for w in range(L // 32):
            sel = live[32 * w:32 * w + 32]
            if sel.any():
                warps += 1
                ns = np.unique(n[32 * w:32 * w + 32][sel])
                if ns.size > 1:
                    mixed += 1
                    worst.append(ns.tolist())
        log.append(dict(live_warps=warps, mixed_warps=mixed,
                        mixed=worst[:4]))
        return host, done

    E.BatchEngine._read_back = read_back
    conf = Configure()
    conf.batch.lanes = L
    conf.batch.value_stack_depth = 256
    conf.batch.call_stack_depth = 256
    vm = VM(conf)
    vm.load_wasm(build_fib())
    vm.validate()
    vm.instantiate()
    out = {}
    runs = (("uncompacted", base, False, True),
            ("presorted", np.sort(base), False, True),
            ("warp_aligned", 20 + (np.arange(L) // 32) % 11, False, True),
            ("compacted", base, True, True),
            ("compacted_no_narrow", base, True, False))
    for name, args, compact, narrow in runs:
        ARGS[0] = args
        vm.conf.batch.compact = compact
        vm.conf.batch.compact_narrow = narrow
        log.clear()
        run = cs.run_main(vm, "fib", [args], 1 << 20, ("interp", "block"))
        want = np.array([cs.fib_py(int(k)) for k in range(31)])[args]
        if not (run[0].results[0] == want).all():
            cs.fail(f"{name}: results")
        retired = int(run[0].retired.astype(np.int64).sum())
        rec = cs.report_main(name, run, retired)
        rec["per_launch"] = list(log)
        rec["profile"] = cs.profile_run(vm, "fib", [args], retired)
        out[name] = rec
        print(f"  {name}: mixed live warps per launch "
              f"{[(e['live_warps'], e['mixed_warps']) for e in log]}; last "
              f"mixed {log[-1]['mixed']}", flush=True)
    print("compact_groups ok", flush=True)
    print(json.dumps(out, default=str), flush=True)


ARGS = [None]

if __name__ == "__main__":
    main()
