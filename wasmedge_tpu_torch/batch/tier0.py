"""Tier-0 host calls: the value-producing parts, over torch.int32 tensors.

The torch copy of `wasmedge_tpu/batch/tier0.py`.  Pure WASI calls
(clock_time_get, random_get, sched_yield, proc_exit and fd_write to fd 1
or 2) are retired inside the interpreter instead of parking for the host;
what they compute lives here once: the counter-PRNG behind random_get, its
per-word whitening and per-(lane, call) seed, the clock value, and the
byte-granular masked stores.  `batch/interp_ref.py` runs these functions;
`csrc/interp.cu` (`tier0_call`) computes the same bits on the card.

Memory is reached through the caller's primitives, as in the reference:

  gather(plane, idx) -> [n]     per-lane word at row idx (rows clamped)
  rmw(plane, idx, m, v, ok)     plane[idx] = (cur & ~m) | (v & m) where
                                ok & (m != 0), else unchanged; returns
                                the plane

Every argument and result is an int32 tensor on one device (lanes
elementwise); the 32-bit products and logical shifts are computed in
int64 and wrapped, so the bits are the reference's.
"""

from __future__ import annotations

import os

import torch

from wasmedge_tpu_torch.host.wasi.wasi_abi import Errno

I32 = torch.int32
I64 = torch.int64
_M32 = 0xFFFFFFFF
BYTE_MASKS = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)
# the avalanche's multipliers, the lane and call-sequence constants and
# the per-word whitening step (tier0.py of the reference)
PRNG_MUL1 = 0x7FEB352D
PRNG_MUL2 = 0x846CA68B
LANE_MUL = 0x9E3779B9  # np.int32(-1640531527)
SEQ_MUL = 0x85EBCA6B
WORD_MIX = 0x27220A95


def _u(x):
    """int32 (or int64) -> its low 32 bits as a non-negative int64."""
    return x.to(I64) & _M32


def _wrap(v):
    """A non-negative int64 below 2**32 (or any int64) -> int32 bits."""
    v = v & _M32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(I32)


def _mul32(u, c: int):
    """(u * c) mod 2**32 for u in [0, 2**32), without leaving int64."""
    lo = u * (c & 0xFFFF)
    hi = ((u * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def s32(v: int) -> int:
    """A 32-bit pattern as the signed int the int32 planes hold."""
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def t0_statics(cfg) -> dict:
    """Tier-0 constants of a `BatchConfigure`: the longest random_get and
    fd_write payloads in words, the PRNG seed (drawn from os.urandom once
    per configuration when `rng_seed` is None, as the reference does) and
    the errnos (host/wasi/wasi_abi)."""
    seed = cfg.rng_seed
    if seed is None:
        seed = getattr(cfg, "_rng_seed_drawn", None)
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
            cfg._rng_seed_drawn = seed
    return {
        "RMAX_W": max(int(cfg.tier0_random_max), 4) // 4,
        "WMAX_W": max(int(cfg.tier0_write_max), 4) // 4,
        "RNG_SEED": s32(int(seed)),
        "E_INVAL": int(Errno.INVAL),
        "E_FAULT": int(Errno.FAULT),
    }


def t0_prng32(x):
    """Counter-PRNG avalanche (xorshift-multiply on 32 bits) behind
    tier-0 random_get."""
    u = _u(x)
    u = u ^ (u >> 16)
    u = _mul32(u, PRNG_MUL1)
    u = u ^ (u >> 15)
    u = _mul32(u, PRNG_MUL2)
    u = u ^ (u >> 16)
    return _wrap(u)


def t0_word_mix(j: int) -> int:
    """Per-word whitening constant of the random stream (signed int32)."""
    return s32(j * WORD_MIX)


def t0_rng_seq_hash(rng_seed, lane_iota, ctr):
    """Per-(lane, call sequence) hash seeding the random_get word
    stream; `rng_seed` an int (or int32 tensor), `lane_iota` the lanes'
    global indices, `ctr` their random_get counts."""
    lane = _mul32(_u(lane_iota) + 1, LANE_MUL)
    seed = torch.as_tensor(rng_seed, dtype=I64, device=lane.device) & _M32
    lane_h = _u(t0_prng32(_wrap(seed ^ lane)))
    return _wrap(lane_h ^ _mul32(_u(ctr), SEQ_MUL))


def t0_clock_value(t0_time, cid, ctr):
    """clock_time_get's value: the launch's time base (row 0 realtime,
    row 1 monotonic, each an int32 (lo, hi) pair; `t0_time` [2, 2]) plus
    the lane's clock call count, as an int32 (lo, hi) pair."""
    tt = torch.as_tensor(t0_time, dtype=I64, device=cid.device) & _M32
    base = torch.where((cid == 1)[:, None], tt[1][None, :], tt[0][None, :])
    v = (base[:, 0] | (base[:, 1] << 32)) + _u(ctr)  # wraps mod 2**64
    return _wrap(v), _wrap(v >> 32)


def t0_masked_store(rmw, plane, ea, v_lo, v_hi, nbytes_c: int, ok):
    """Masked little-endian store of nbytes_c (4 or 8) bytes of (v_lo,
    v_hi) at per-lane byte address ea (bounds checked by the caller) on
    the lanes of `ok`, through `rmw`: the three words it can touch."""
    ea64 = _u(ea)
    widx = ea64 >> 2
    sh = (ea64 & 3) * 8
    inv = (32 - sh) & 31
    spill = torch.where(sh == 0, 0, _M32)
    zero = torch.zeros_like(ea64)
    # the value's and the mask's words, shifted up by sh across three
    # plane words
    hi = _u(v_hi) if nbytes_c == 8 else zero
    vals = (_u(v_lo), hi, zero)
    masks = (zero + _M32, zero + (_M32 if nbytes_c == 8 else 0), zero)
    for k in range(3):
        mk = (masks[k] << sh) & _M32
        vk = (vals[k] << sh) & _M32
        if k:
            mk = mk | ((masks[k - 1] >> inv) & spill)
            vk = vk | ((vals[k - 1] >> inv) & spill)
        plane = rmw(plane, (widx + k).to(I32), _wrap(mk), _wrap(vk), ok)
    return plane


def t0_random_fill(rmw, mem, rbuf, rend, wr, seq_h, rmax_w: int, zero):
    """random_get's word loop: the counter-PRNG stream into guest bytes
    [rbuf, rend) on the lanes of `wr`, byte-granular at both edges, in
    rmax_w + 1 shifted windows (the stream layout every engine shares)."""
    shb = (_u(rbuf) & 3) * 8
    inv = (32 - shb) & 31
    hi_or = torch.where(shb == 0, 0, _M32)
    w0 = _u(rbuf) >> 2
    lo_b, hi_b = _u(rbuf), _u(rend)
    prev = _u(zero)
    for j in range(rmax_w + 1):
        pw = _u(t0_prng32(seq_h ^ t0_word_mix(j))) if j < rmax_w \
            else _u(zero)
        val = ((pw << shb) & _M32) | ((prev >> inv) & hi_or)
        mk = torch.zeros_like(w0)
        for bpos in range(4):
            ba = ((w0 + j) * 4 + bpos) & _M32
            inr = (ba >= lo_b) & (ba < hi_b)
            mk = mk | torch.where(inr, BYTE_MASKS[bpos], 0)
        mem = rmw(mem, (w0 + j).to(I32), _wrap(mk), _wrap(val), wr)
        prev = pw
    return mem


def t0_shifted_src_word(gather, mem, w0, j: int, shb, inv, hi_or):
    """fd_write's record payload: the j-th source word of a guest buffer
    at any byte offset, from the two plane words it straddles (`w0` the
    first word, `shb` the byte offset in bits, `inv` (32 - shb) & 31,
    `hi_or` all ones unless shb is 0); the record itself is always
    word-aligned."""
    s0 = _u(gather(mem, (_u(w0) + j).to(I32)))
    s1 = _u(gather(mem, (_u(w0) + j + 1).to(I32)))
    return _wrap((s0 >> _u(shb)) | ((s1 << _u(inv)) & _u(hi_or)))
