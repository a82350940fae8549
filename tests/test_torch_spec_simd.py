"""BASELINE config 3 on the port: the SIMD spec corpus, batched, strict.

`tests/spec/simd.wast` (2,593 assert_return commands over 215 exports of
one memory-free module; expected values from an independent plain-Python
generator, tests/spec/_generate_r4.py) runs through the port's
`run_corpus_batched` on the plain interpreter, one assertion per lane.
Matching is strict: no allowance for flushed binary32 subnormals.  Every
assertion must pass; the only commands the batched runner may skip are
assertions with v128 arguments or results, and this file has none.
"""

import os

from wasmedge_tpu_torch.spec import run_corpus_batched

SIMD_WAST = os.path.join(os.path.dirname(__file__), "spec", "simd.wast")
ASSERTIONS = 2593


def test_simd_corpus_passes_strictly_on_the_batch_engine():
    rep = run_corpus_batched([SIMD_WAST], device="cpu")
    print(f"simd.wast: {rep.passed} passed, {rep.failed} failed, "
          f"{rep.skipped} skipped")
    assert rep.failed == 0, [str(f) for f in rep.failures[:10]]
    assert rep.skipped == 0
    assert rep.passed == ASSERTIONS
