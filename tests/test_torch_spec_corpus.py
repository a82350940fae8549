"""The batchable non-SIMD spec corpus through the port's corpus runner on the CPU, strict.

`wasmedge_tpu_torch.spec.run_corpus_batched(paths, device, conf)` runs
each `.wast` file of `tests/spec/` but `simd.wast` (its own file,
`test_torch_spec_simd.py`), `call_gen.wast` (54 s on the CPU: its own
file, `test_torch_spec_corpus_call_gen.py`) and the table and tail-call
files (`test_torch_spec_tables.py`) with the reference test's
`conf` (`tests/test_spec.py:77-82`: 2048 frames and 8192 value slots, so
that call.wast's `even(1000)` fits) and `optimistic` on, its default:
one assertion per lane, so every export diverges inside its warps and
rolls back.  Each file must fail nothing and pass and skip the counts
measured (7,155 passed, 0 failed, 345 skipped over the 22 files with
call_gen.wast and the table files); the skipped assertions are those of
stateful modules (memories, globals, tables mutated outside the
`*_batch.wast` files).  Matching is strict: `f32_subnormal.wast`, which
the reference's batched runner skips, passes 162 of 162.
"""

import os

import pytest

from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.spec import run_corpus_batched

SPEC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "spec")

# file -> (passed, skipped)
COUNTS = {
    "bulk_memory.wast": (0, 158),
    "call.wast": (17, 1),
    "control.wast": (24, 0),
    "control_gen.wast": (324, 0),
    "conversions.wast": (56, 0),
    "errors.wast": (0, 19),
    "f32.wast": (978, 0),
    "f32_subnormal.wast": (162, 0),
    "f64.wast": (1140, 0),
    "float.wast": (63, 0),
    "globals.wast": (0, 14),
    "i32.wast": (1484, 0),
    "i64.wast": (1498, 0),
    "memory.wast": (0, 63),
    "numeric_conversions.wast": (1004, 0),
    "official_style.wast": (11, 9),
}


def reference_conf() -> Configure:
    """tests/test_spec.py's depths for the batched corpus."""
    conf = Configure()
    conf.batch.call_stack_depth = 2048
    conf.batch.value_stack_depth = 8192
    return conf


def run_file(name, counts=None):
    """One file with the reference's depths: no failure, and (passed,
    skipped) equal to `counts` (COUNTS[name] when None)."""
    conf = reference_conf()
    assert conf.batch.optimistic is None
    rep = run_corpus_batched([os.path.join(SPEC, name)], device="cpu",
                             conf=conf)
    detail = "\n".join(str(f) for f in rep.failures[:10])
    assert rep.failed == 0, f"{name}: {rep.failed} failed:\n{detail}"
    assert (rep.passed, rep.skipped) == (counts or COUNTS[name])


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_corpus_file_passes_strictly(name):
    run_file(name)


def test_the_counts_cover_the_non_simd_corpus():
    from tests.test_torch_spec_tables import TABLE_COUNTS

    files = {f for f in os.listdir(SPEC) if f.endswith(".wast")}
    assert not set(COUNTS) & set(TABLE_COUNTS)
    assert files - set(COUNTS) - set(TABLE_COUNTS) == {"simd.wast",
                                                       "call_gen.wast"}
    counts = list(COUNTS.values()) + [(p, s) for p, _, s in
                                      TABLE_COUNTS.values()]
    assert sum(p for p, _ in counts) + 307 == 7155
    assert sum(s for _, s in counts) == 345


def test_conf_is_copied_and_its_depths_are_used():
    """The runner deepens nothing itself: at the port's default depths
    call.wast's even(1000) exhausts the 512 frames on its lane; the
    caller's conf is left as it was."""
    conf = Configure()
    rep = run_corpus_batched([os.path.join(SPEC, "call.wast")],
                             device="cpu", conf=conf)
    assert rep.failed == 1 and "trapped 144" in str(rep.failures[0])
    assert conf.batch.steps_per_launch == Configure().batch.steps_per_launch
