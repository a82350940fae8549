"""The port's plain v128 ops against the reference's, op by op.

Every op of the batchable v128 set (`SUPPORTED_V128`, 216 ops) that
works on stack values goes through `wasmedge_tpu_torch.batch.simdops` and
through `wasmedge_tpu.batch.simdops` (evaluated eagerly by JAX on the
CPU, so that no op is compiled) on the same 4-plane inputs: 64 lanes of
seeded random words mixed with edge words (0, +-1, 0x7F, 0x80, 0x7FFF,
0x8000, INT_MIN, +-0.0, +-inf, quiet and signalling NaNs with payloads,
binary32 and binary64 subnormals) and words of corner bytes (0x00, 0x01,
0x7F, 0x80, 0xFE, 0xFF).  Every word of every lane must be equal
(tolerance 0).  Extract and replace run at every lane index, shifts at
counts 0, 1, width - 1, width, 31, 63, 64 and 127 besides random ones.

One documented exception (ROADMAP queue C1): XLA's CPU backend flushes
binary32 subnormals in the f32 operations that run on the float hardware.
The port keeps IEEE subnormals, so in those ops the elements whose
operands or IEEE result are binary32 subnormals are held, still bit for
bit, against numpy's IEEE binary32 arithmetic instead.

v128.const, v128.load, v128.store and i8x16.shuffle's table row are
interpreter handlers, not stack-value ops; tests/test_torch_simd.py holds
them against the reference engines.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wasmedge_tpu.batch import simdops as ref
from wasmedge_tpu_torch.batch import simdops as port
from tests.test_torch_alu import _ieee_f32

LANES = 64
_RNG = np.random.default_rng(20261016)

EDGE32 = [0, 1, -1, 2, 0x7F, 0x80, 0xFF, 0x7FFF, 0x8000, 0xFFFF, 0x10000,
          -2**31, 2**31 - 1, 0x80808080, 0x7F7F7F7F, 0x00FF00FF, 0xFF00FF00,
          0x80008000, 0x7FFF7FFF, 0x00800080, 0x01FE01FE,
          0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
          0x7FC12345, 0x7FA00000, 0xFF812345, 0x00000001, 0x80000001,
          0x007FFFFF, 0x807FFFFF, 0x00400000, 0x00800000, 0x3F800000,
          0xBFC00000, 0x4F000000, 0xCF000001, 0x4F800000, 0x5F000000,
          0x3EAAAAAB, 0x40490FDB, 0x3F7FFFFF]
EDGE64 = [0x8000000000000000, 0x7FF0000000000000, 0xFFF0000000000000,
          0x7FF8000000000000, 0xFFF8000000000000, 0x7FF0000000000001,
          0x7FF8000000012345, 0x0000000000000001, 0x8000000000000001,
          0x000FFFFFFFFFFFFF, 0x0010000000000000, 0x3FF0000000000000,
          0xBFF8000000000000, 0x41E0000000000000, 0xC1E0000000200000,
          0x41F0000000000000, 0x43E0000000000000, 0xC3E0000000000001,
          0x400921FB54442D18, 0x36A0000000000000, 0x380FFFFFFFFFFFFF,
          0x47EFFFFFE0000000, 0x7FFFFFFFFFFFFFFF, 0x0000000100000000]
CORNER_BYTES = [0x00, 0x01, 0x7F, 0x80, 0xFE, 0xFF]
SHIFTS = [0, 1, 7, 8, 15, 16, 31, 32, 63, 64, 127]


def _s32(v):
    v &= 0xFFFFFFFF
    return v - 2**32 if v >= 2**31 else v


def _planes(seed):
    """Four int32 [LANES] planes: per 64-bit half, a binary64 edge, or
    per word a 32-bit edge, a word of corner bytes or random bits."""
    rng = np.random.default_rng(seed)
    out = np.zeros((4, LANES), np.int64)
    for lane in range(LANES):
        for k in (0, 2):
            if rng.random() < 0.25:
                v = EDGE64[rng.integers(len(EDGE64))]
                out[k, lane], out[k + 1, lane] = _s32(v), _s32(v >> 32)
                continue
            for j in (k, k + 1):
                r = rng.random()
                if r < 0.4:
                    out[j, lane] = _s32(EDGE32[rng.integers(len(EDGE32))])
                elif r < 0.7:
                    bs = rng.choice(CORNER_BYTES, 4)
                    out[j, lane] = _s32(int.from_bytes(bytes(bs), "little"))
                else:
                    out[j, lane] = _s32(int(rng.integers(0, 2**32)))
    return out.astype(np.int32)


X, Y, W = _planes(1), _planes(2), _planes(3)


def _run(ref_fn, port_fn, *planes):
    """Both functions on the same int32 planes (each argument a [k, LANES]
    array or a [LANES] one); results as [n, LANES] int32 arrays."""
    def as_args(mk):
        return [tuple(mk(w) for w in p) if p.ndim == 2 else mk(p)
                for p in planes]
    r = ref_fn(*as_args(jnp.asarray))
    p = port_fn(*as_args(lambda a: torch.from_numpy(a.copy())))
    if not isinstance(r, tuple):
        r, p = (r,), (p,)
    return (np.stack([np.asarray(v, np.int32) for v in r]),
            np.stack([v.numpy().astype(np.int32) for v in p]))


# f32 element ops that run on the float hardware in the reference, with
# the scalar op of the same bits, and whether the op is binary
_FTZ = {"f32x4.add": ("f32.add", 2), "f32x4.sub": ("f32.sub", 2),
        "f32x4.mul": ("f32.mul", 2), "f32x4.div": ("f32.div", 2),
        "f32x4.sqrt": ("f32.sqrt", 1), "f32x4.ceil": ("f32.ceil", 1),
        "f32x4.floor": ("f32.floor", 1), "f32x4.trunc": ("f32.trunc", 1),
        "f32x4.nearest": ("f32.nearest", 1)}


def _check(name, got, want, operands):
    """Every word equal, except binary32-subnormal elements of the f32
    ops on the float hardware, which equal numpy's IEEE binary32."""
    want = want.copy()
    if name in _FTZ:
        scalar, arity = _FTZ[name]
        ieee, sub = _ieee_f32(scalar, *operands[:arity])
        want[sub] = ieee[sub]
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", port.V2_NAMES)
def test_binary_op_matches_reference(name):
    sub = port.V2_SUB[name]
    assert ref.V2_NAMES[sub] == name
    got_ref, got = _run(ref.v2_fn(sub), port.v2_fn(sub), X, Y)
    _check(name, got, got_ref, (X, Y))


@pytest.mark.parametrize("name", port.V1_NAMES)
def test_unary_op_matches_reference(name):
    sub = port.V1_SUB[name]
    assert ref.V1_NAMES[sub] == name
    got_ref, got = _run(ref.v1_fn(sub), port.v1_fn(sub), X)
    _check(name, got, got_ref, (X,))


@pytest.mark.parametrize("name", port.VTEST_NAMES)
def test_test_op_matches_reference(name):
    sub = port.VTEST_SUB[name]
    for x in (X, Y):
        # all_true needs lanes with no zero element as well
        x = np.where(np.arange(LANES) % 3 == 0, x | 0x01010101, x) \
            .astype(np.int32)
        got_ref, got = _run(ref.vtest_fn(sub), port.vtest_fn(sub), x)
        _check(name, got, got_ref, (x,))


@pytest.mark.parametrize("name", port.VSHIFT_NAMES)
def test_shift_op_matches_reference(name):
    sub = port.VSHIFT_SUB[name]
    counts = np.resize(np.array(
        SHIFTS + list(_RNG.integers(-2**31, 2**31, 8)), np.int64), LANES)
    n = counts.astype(np.int32)
    got_ref, got = _run(ref.vshift_fn(sub), port.vshift_fn(sub), X, n)
    _check(name, got, got_ref, (X,))


@pytest.mark.parametrize("name", port.VSPLAT_NAMES)
def test_splat_op_matches_reference(name):
    sub = port.VSPLAT_SUB[name]
    got_ref, got = _run(ref.vsplat_fn(sub), port.vsplat_fn(sub), X[0], X[1])
    _check(name, got, got_ref, (X,))


def _lanes_of(name):
    return {"i8x16": 16, "i16x8": 8, "i32x4": 4, "f32x4": 4, "i64x2": 2,
            "f64x2": 2}[name.split(".")[0]]


@pytest.mark.parametrize("name", port.VEXTRACT_NAMES)
def test_extract_op_matches_reference_at_every_lane(name):
    sub = port.VEXTRACT_SUB[name]
    lane = (np.arange(LANES) % _lanes_of(name)).astype(np.int32)
    got_ref, got = _run(ref.vextract_dyn(sub), port.vextract_dyn(sub), X,
                        lane)
    _check(name, got, got_ref, (X,))


@pytest.mark.parametrize("name", port.VREPLACE_NAMES)
def test_replace_op_matches_reference_at_every_lane(name):
    sub = port.VREPLACE_SUB[name]
    lane = (np.arange(LANES) % _lanes_of(name)).astype(np.int32)
    got_ref, got = _run(ref.vreplace_dyn(sub), port.vreplace_dyn(sub), X,
                        lane, Y[0], Y[1])
    _check(name, got, got_ref, (X,))


def test_bitselect_matches_reference():
    got_ref, got = _run(ref.vbitselect(), port.vbitselect, W, X, Y)
    _check("v128.bitselect", got, got_ref, (W,))


def test_shuffle_matches_reference():
    """Selector bytes 0..31 pick from both operands; 32 and above give 0
    (the validator admits 0..31 only; the reference's rule is kept)."""
    sel = _RNG.integers(0, 40, (4, LANES, 4)).astype(np.uint8)
    m = sel.view(np.int32)[..., 0]
    got_ref, got = _run(ref.vshuffle_dyn(), port.vshuffle_dyn, X, Y, m)
    _check("i8x16.shuffle", got, got_ref, (X,))


def test_every_batchable_op_is_covered():
    named = (set(port.V2_NAMES) | set(port.V1_NAMES) | set(port.VTEST_NAMES)
             | set(port.VSHIFT_NAMES) | set(port.VSPLAT_NAMES)
             | set(port.VEXTRACT_NAMES) | set(port.VREPLACE_NAMES)
             | {"v128.bitselect", "i8x16.shuffle"})
    handlers = {"v128.const", "v128.load", "v128.store"}
    assert port.SUPPORTED_V128 == ref.SUPPORTED_V128
    assert len(port.SUPPORTED_V128) == 216
    assert port.SUPPORTED_V128 == named | handlers
    for table in ("V2_SUB", "V1_SUB", "VTEST_SUB", "VSHIFT_SUB",
                  "VSPLAT_SUB", "VEXTRACT_SUB", "VREPLACE_SUB"):
        assert getattr(port, table) == getattr(ref, table), table
