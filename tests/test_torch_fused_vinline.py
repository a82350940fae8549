"""B7's v128 ops inside B2 blocks: each inlined by its literal sub, shuffles and constants as literals.

The generator writes every v2 and v1 op of a block as `v2_fn(sub, ...)` /
`v1_fn(sub, ...)` with the sub a literal (force-inlined in csrc/interp.cu,
so nvcc folds the op to its own instructions; no out-of-line `v2_op` /
`v1_op` call), a v128.const of an instance case as four literal words and
an i8x16.shuffle as literal `__byte_perm`s.  Checked here: the generated
text, the folded shuffle against the kernel's rule on random selectors
(out-of-range ones included), and a module whose blocks hold every v2
and v1 sub run launch by launch against the reference SIMT `BatchEngine`
(the port's plain engine with the "blocks" encoding, live planes equal
after every launch; tolerance: bit-exact) on operands without binary32
subnormals (ROADMAP C5), and lane by lane against the scalar oracle with
random and corner-byte operands.  The kernel is held to the plain version on the card (the
`cuda` test here and `chip_smoke.py`).
"""

import re
import types

import numpy as np
import pytest
import torch

from wasmedge_tpu_torch.batch import fusegen, interp_ref
from wasmedge_tpu_torch.batch.fusion import H_BLOCK_BASE
from wasmedge_tpu_torch.batch.interp import run_chunk
from wasmedge_tpu_torch.batch.simdops import V1_SUB, V2_SUB
from wasmedge_tpu_torch.models import build_simd_loop
from wasmedge_tpu_torch.models.fixtures import (
    build_vmix, build_vsub_blocks, simd_sweep_args, vsub_args)
from tests.test_torch_fused_instances import (
    _tables, instance_cases, per_launch)
from tests.test_torch_simd import _oracle_check


def test_every_v2_and_v1_sub_is_inlined_with_a_literal_sub():
    t = _tables(build_vsub_blocks())
    fused = {op for s in t.shapes for op in s if op[0] in ("v2", "v1")}
    assert fused == {("v2", k) for k in V2_SUB.values()} | \
        {("v1", k) for k in V1_SUB.values()}
    src = t.fused_source
    assert "v2_op(" not in src and "v1_op(" not in src
    subs = {(m.group(1), int(m.group(2)))
            for m in re.finditer(r"\b(v[12])_fn\((\d+),", src)}
    assert subs == fused


def test_v128_literals_in_instance_cases():
    """vloop's and vmix's v128.const values and shuffle selectors are
    literals of their cases, the same words as the v128 table rows."""
    for build in (build_simd_loop, build_vmix):
        t = _tables(build())
        table = t.v128.view(-1, 4).tolist()
        cases = instance_cases(t.fused_source)
        consts = shuffles = 0
        for pc, text in cases.items():
            shape = t.shapes[int(t.hid[pc]) - H_BLOCK_BASE]
            for j, op in enumerate(shape):
                if op[0] not in ("vconst", "vshuffle"):
                    continue
                row = [w & 0xFFFFFFFF for w in table[int(t.a[pc + j])]]
                if op[0] == "vconst":
                    consts += 1
                    words = ", ".join(f"0x{w:08x}u" for w in row)
                    assert f"V4{{{{{words}}}}}" in text
                else:
                    shuffles += 1
                    assert "__byte_perm(" in text or ".w[" in text
        assert consts and shuffles


def _shuffle_ref(x, y, mk):
    """interp.cu shuffle_word: byte j of the result is byte m_j of the
    32 bytes of (x, y), 0 when m_j >= 32."""
    src = b"".join(int(w).to_bytes(4, "little") for w in x + y)
    out = bytes(src[m] if m < 32 else 0
                for m in ((mk >> (8 * j)) & 0xFF for j in range(4)))
    return int.from_bytes(out, "little")


def _byte_perm(x, y, s):
    v = (y << 32) | x
    return sum(((v >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def test_folded_shuffle_word_matches_the_kernel_rule():
    rng = np.random.default_rng(7)
    for trial in range(400):
        x = [int(w) for w in rng.integers(0, 2**32, 4)]
        y = [int(w) for w in rng.integers(0, 2**32, 4)]
        hi = 32 if trial % 2 else 256   # in range, or any byte
        sel = [int(b) for b in rng.integers(0, hi, 4)]
        if trial % 5 == 0:
            sel = [4 * (trial % 8) + j for j in range(4)]  # a whole word
        mk = sum(b << (8 * j) for j, b in enumerate(sel))
        expr = fusegen._shuffle_word("x", "y", mk)
        py = re.sub(r"\b(0x[0-9a-f]+|\d+)u\b", r"\1", expr)
        got = eval(py, {"__byte_perm": _byte_perm,
                        "x": types.SimpleNamespace(w=x),
                        "y": types.SimpleNamespace(w=y)})
        assert got == _shuffle_ref(x, y, mk), (sel, expr)


def test_vsub_blocks_match_simt_every_launch():
    """Operands without binary32 subnormals (the reference flushes them in
    f32x4 ops, ROADMAP C5)."""
    port, tables = per_launch(build_vsub_blocks(), "f", vsub_args(12, 11),
                              97)
    assert tables.has_simd and port.stack_e2 is not None
    assert (port.trap.numpy() == -1).all()


@pytest.mark.parametrize("corners", [False, True], ids=["random", "corners"])
def test_vsub_blocks_match_scalar_oracle(corners):
    """Random and corner-byte operands, subnormals included, lane by lane
    against the reference's scalar interpreter (as the sweeps are)."""
    _oracle_check(build_vsub_blocks(), "f", simd_sweep_args(8, 11, corners),
                  8)


@pytest.mark.cuda
def test_cuda_vsub_blocks_match_plain_every_launch_all_rows():
    """On the card: the fused kernel of the every-sub module, careful and
    optimistic, against the plain version, every plane and row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from tests.test_torch_interp import _assert_same_state
    from wasmedge_tpu_torch.batch.engine import BatchEngine
    from wasmedge_tpu_torch.batch.optimistic import WarpState
    from wasmedge_tpu_torch.common.configure import Configure
    from wasmedge_tpu_torch.executor.instantiate import instantiate
    from wasmedge_tpu_torch.loader import Loader
    from wasmedge_tpu_torch.runtime.store import StoreManager
    from wasmedge_tpu_torch.validator import Validator

    lanes = 64
    for corners in (False, True):
        for opt in (None, False):
            conf = Configure()
            conf.batch.value_stack_depth, conf.batch.call_stack_depth = 64, 16
            conf.batch.optimistic = opt
            mod = Validator(conf).validate(Loader(conf).parse_module(
                build_vsub_blocks()))
            inst = instantiate(StoreManager(), mod, conf)
            eng = BatchEngine(inst, conf=conf, lanes=lanes, device="cuda")
            st = eng.initial_state(inst.exports["f"][1], simd_sweep_args(
                lanes, 11, corners=corners))
            ref = st.clone()
            wk, wp = ((WarpState.new(lanes, "cuda"),
                       WarpState.new(lanes, "cuda"))
                      if eng.tables.optimistic else (None, None))
            for _ in range(300):
                run_chunk(eng.tables, st, 97, False, wk)
                interp_ref.run_chunk(eng.tables, ref, 97, False, wp)
                _assert_same_state(st, ref)
                if not bool((st.trap == 0).any()):
                    break
