"""call_gen.wast through the port's corpus runner on the CPU, strict.

The generated call corpus (307 assertions, deep recursion) takes most of
a minute on the CPU, so it has a file of its own beside
`test_torch_spec_corpus.py`, with the same `conf` (2048 frames, 8192
value slots) and `optimistic` on.
"""

from tests.test_torch_spec_corpus import run_file


def test_call_gen_passes_strictly():
    run_file("call_gen.wast", (307, 0))
