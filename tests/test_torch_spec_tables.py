"""The table and tail-call files of the spec corpus through the port's corpus runner.

`table.wast`, `table_batch.wast`, `tail_call.wast`, `tail_call_batch.wast`
and `ref_types.wast` with the reference test's depths (2048 frames, 8192
value slots), strict, one assertion per lane.  Each file must give the
JAX package's batched runner's counts (passed, failed, skipped),
measured with `wasmedge_tpu.spec.run_corpus_batched` on the CPU:

  table_batch.wast      52 / 0 / 0
  tail_call_batch.wast  20 / 0 / 0
  tail_call.wast        15 / 0 / 1   (the assert_exhaustion command)
  table.wast             0 / 0 / 62
  ref_types.wast         0 / 0 / 18

`table.wast` and `ref_types.wast` are skipped whole by the reference
runner's own rule, which the port's runner copies: their modules mutate
tables outside a `*_batch.wast` file, so lanes would see one another's
state (wasmedge_tpu/spec/__init__.py:405-424).

The plain interpreter takes about a millisecond a dispatch here (a
group of lanes, a few torch calls an op), and the tail-call files run
long loops: even(200000) and count(50000) in `tail_call.wast` (about ten
minutes here), sumto(20000) and even(10001) in `tail_call_batch.wast`
(two).  So those two run to their end on the card (a `cuda` test, and
chip_smoke.py's corpus phase, which holds every one of these files to
its counts), and here each file's modules run with every assertion whose
loop stays under 1000 calls.
"""

import os

import pytest
import torch

from wasmedge_tpu_torch.spec import run_corpus_batched
from tests.test_torch_spec_corpus import SPEC, reference_conf

# file -> (passed, failed, skipped): the JAX package's batched runner's
TABLE_COUNTS = {
    "table.wast": (0, 0, 62),
    "table_batch.wast": (52, 0, 0),
    "tail_call.wast": (15, 0, 1),
    "tail_call_batch.wast": (20, 0, 0),
    "ref_types.wast": (0, 0, 18),
}
# the files the plain version runs to their end within a test's time
CPU_FILES = ("ref_types.wast", "table.wast", "table_batch.wast")
# the others' assertions whose loops run 1000 calls or more, and what
# each file gives without them
LONG_ARGS = {"tail_call.wast": ("(i64.const 100001)", "(i64.const 200000)",
                                "(i64.const 50000)"),
             "tail_call_batch.wast": ("(i32.const 5000)", "(i32.const 20000)",
                                      "(i32.const 10000)",
                                      "(i32.const 10001)")}
SHORT_COUNTS = {"tail_call.wast": (12, 0, 1),
                "tail_call_batch.wast": (14, 0, 0)}


def run_tables_file(path, counts, device="cpu"):
    rep = run_corpus_batched([path], device=device, conf=reference_conf())
    detail = "\n".join(str(f) for f in rep.failures[:10])
    assert (rep.passed, rep.failed, rep.skipped) == counts, detail


@pytest.mark.parametrize("name", sorted(CPU_FILES))
def test_corpus_file_passes_strictly(name):
    run_tables_file(os.path.join(SPEC, name), TABLE_COUNTS[name])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LONG_ARGS))
def test_tail_call_file_passes_strictly_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip(f"needs a CUDA device: {name}'s loops take minutes in "
                    f"the plain version")
    run_tables_file(os.path.join(SPEC, name), TABLE_COUNTS[name],
                    device="cuda")


@pytest.mark.parametrize("name", sorted(LONG_ARGS))
def test_tail_call_file_with_its_short_assertions(name, tmp_path):
    """The file's modules with every assertion whose loop stays under
    1000 calls (tail_call.wast: even 0, 1, 7, 100, count 0, 1, 5, fac
    0 ... 25, and its assert_exhaustion command, skipped as in the whole
    file; tail_call_batch.wast: sumto and sumto_i of 0, 1, 7, 512, even 0,
    1, 2, 999 and both call_indirect traps)."""
    lines = open(os.path.join(SPEC, name)).read().splitlines()
    kept = [ln for ln in lines
            if not (ln.startswith("(assert")
                    and any(x in ln for x in LONG_ARGS[name]))]
    passed, failed, skipped = TABLE_COUNTS[name]
    assert len(lines) - len(kept) == passed - SHORT_COUNTS[name][0]
    path = tmp_path / name
    path.write_text("\n".join(kept))
    run_tables_file(str(path), SHORT_COUNTS[name])
