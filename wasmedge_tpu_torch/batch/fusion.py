"""Fused encodings of the code tables: basic blocks (B2) and superinstructions (B6).

Copies of the two planners of `wasmedge_tpu/batch/pallas_engine.py`:
`fuse_blocks` (:429-569) rewrites the head slot of every maximal
straight-line run of pure stack ops to `H_BLOCK_BASE + shape id`, and
`fuse_image` (:269-388) rewrites the head slot of ten fixed 2-4 op
patterns to a superinstruction id.  Both leave every absorbed slot with
its original handler id and operands, so any pc stays dispatchable one
op at a time.  They return the same planes and shapes as the reference
functions on the same image, and are deterministic.

The warp-interpreter (`batch/interp.py`) runs a fused dispatch only when
the lane's remaining steps in the launch and its remaining fuel cover the
whole fused length (`fused_lengths`); otherwise the lane runs the head
slot's original op and goes on one op at a time, so a launch ends at the
same instruction as the per-op interpreter.
"""

from __future__ import annotations

import numpy as np

from wasmedge_tpu_torch.batch import laneops
from wasmedge_tpu_torch.batch.image import (
    ALU2_I32_BASE, ALU2_I64_BASE, CLS_ALU1, CLS_ALU2, CLS_BR, CLS_BRNZ,
    CLS_BRZ, CLS_CONST, CLS_DROP, CLS_GLOBAL_GET, CLS_GLOBAL_SET, CLS_LOAD,
    CLS_LOCAL_GET, CLS_LOCAL_SET, CLS_LOCAL_TEE, CLS_MEMSIZE, CLS_NOP,
    CLS_SELECT, CLS_STORE, CLS_V1, CLS_V2, CLS_VBITSEL, CLS_VCONST,
    CLS_VEXTRACT, CLS_VREPLACE, CLS_VSHIFT, CLS_VSHUFFLE, CLS_VSPLAT,
    CLS_VTEST, NUM_ALU1, NUM_ALU2, _I32_BIN)
from wasmedge_tpu_torch.batch.interp import (
    H_ALU2_BASE, H_BRZ, H_BRNZ, H_BR, H_CALL, H_CONST, H_FUSE_A2R_BASE,
    H_FUSE_GBR, H_FUSE_GCA_BASE, H_FUSE_GCB_BASE, H_FUSE_GCC_BASE,
    H_FUSE_GCS_BASE, H_FUSE_GGA_BASE, H_FUSE_GGBNZ_BASE, H_FUSE_GGBZ_BASE,
    H_FUSE_GGS_BASE, H_LOCAL_GET, H_LOCAL_SET, H_RETURN, NUM_HANDLERS)

# ALU2 subs that can trap (div/rem), pallas_engine.py :626-630
_DIV32_SUBS = {ALU2_I32_BASE + _I32_BIN.index(n) for n in
               ("div_s", "div_u", "rem_s", "rem_u")}
_DIV64_SUBS = {ALU2_I64_BASE + _I32_BIN.index(n) for n in
               ("div_s", "div_u", "rem_s", "rem_u")}

H_BLOCK_BASE = NUM_HANDLERS
MAX_BLOCK_SHAPES = 96   # distinct block shapes compiled per kernel
MAX_BLOCK_LEN = 24      # ops per block (incl. the terminal)

# Instructions each superinstruction family retires (pallas_engine.py
# :129-152): GCA/GGA three, GCB/GCC/GCS/GGS/GGBZ/GGBNZ four, A2R and GBR
# two.
SUPER_LEN = {H_FUSE_GCA_BASE: 3, H_FUSE_GCB_BASE: 4, H_FUSE_A2R_BASE: 2,
             H_FUSE_GCC_BASE: 4, H_FUSE_GCS_BASE: 4, H_FUSE_GGA_BASE: 3,
             H_FUSE_GGS_BASE: 4, H_FUSE_GGBZ_BASE: 4, H_FUSE_GGBNZ_BASE: 4}


def super_family(h: int):
    """(family base id, ALU2 sub) of a superinstruction id (GBR: sub
    None), or None for any other id."""
    if h == H_FUSE_GBR:
        return H_FUSE_GBR, None
    if H_FUSE_GCA_BASE <= h < H_FUSE_GBR:
        k = (h - H_FUSE_GCA_BASE) // NUM_ALU2
        base = H_FUSE_GCA_BASE + k * NUM_ALU2
        return base, h - base
    return None


def _targets(img) -> set:
    targets = set(int(x) for x in img.f_entry)
    for pc in range(img.code_len):
        if int(img.cls[pc]) in (CLS_BR, CLS_BRZ, CLS_BRNZ):
            targets.add(int(img.a[pc]))
    for e in range(img.br_table.shape[0]):
        targets.add(int(img.br_table[e, 0]))
    return targets


def fuse_image(hid, a, b, c, ilo, ihi, img):
    """Peephole superinstruction fusion over the flat-hid planes
    (pallas_engine.py :269-388).  Only positions never targeted by a
    branch or call are absorbed, and only non-trapping ALU2 subs fuse.
    Returns rewritten copies of (hid, a, b, c, ilo, ihi)."""
    n = img.code_len
    targets = _targets(img)
    hid, a, b, c, ilo, ihi = (np.array(x, copy=True)
                              for x in (hid, a, b, c, ilo, ihi))
    div = _DIV32_SUBS | _DIV64_SUBS
    pc = 0
    while pc < n - 1:
        h0 = int(hid[pc])
        absorb2 = pc + 1 not in targets
        absorb3 = absorb2 and pc + 2 not in targets and pc + 2 < n
        h1 = int(hid[pc + 1]) if absorb2 else -1
        h2 = int(hid[pc + 2]) if absorb3 else -1
        alu_h2 = H_ALU2_BASE <= h2 < H_ALU2_BASE + NUM_ALU2
        if h0 == H_LOCAL_GET and absorb3 and h1 == H_CONST and alu_h2 \
                and h2 - H_ALU2_BASE not in div:
            sub = h2 - H_ALU2_BASE
            ok4 = pc + 3 not in targets and pc + 3 < n
            h3 = int(hid[pc + 3]) if ok4 else -1
            ilo[pc] = ilo[pc + 1]
            ihi[pc] = ihi[pc + 1]
            quad = {H_BRZ: H_FUSE_GCB_BASE, H_CALL: H_FUSE_GCC_BASE,
                    H_LOCAL_SET: H_FUSE_GCS_BASE}.get(h3)
            if quad is not None:
                # brz target, callee index or dst local
                hid[pc] = quad + sub
                b[pc] = a[pc + 3]
                pc += 4
            else:
                hid[pc] = H_FUSE_GCA_BASE + sub
                pc += 3
            continue
        if h0 == H_LOCAL_GET and absorb3 and h1 == H_LOCAL_GET and alu_h2 \
                and h2 - H_ALU2_BASE not in div:
            sub = h2 - H_ALU2_BASE
            ok4 = pc + 3 not in targets and pc + 3 < n
            h3 = int(hid[pc + 3]) if ok4 else -1
            src1, src2 = int(a[pc]), int(a[pc + 1])
            if h3 in (H_BRZ, H_BRNZ):
                hid[pc] = (H_FUSE_GGBZ_BASE if h3 == H_BRZ
                           else H_FUSE_GGBNZ_BASE) + sub
                a[pc] = a[pc + 3]        # branch target
                if h3 == H_BRNZ:
                    b[pc] = b[pc + 3]    # nkeep
                    c[pc] = c[pc + 3]    # pop_to
                ilo[pc] = src1
                ihi[pc] = src2
                pc += 4
            elif h3 == H_LOCAL_SET:
                hid[pc] = H_FUSE_GGS_BASE + sub
                b[pc] = a[pc + 3]        # dst local
                c[pc] = src2
                pc += 4
            else:
                hid[pc] = H_FUSE_GGA_BASE + sub
                c[pc] = src2
                pc += 3
            continue
        if h0 == H_LOCAL_GET and absorb2 and h1 == H_BR:
            # ilo carries the local index; a/b/c carry the branch
            hid[pc] = H_FUSE_GBR
            ilo[pc] = a[pc]
            a[pc], b[pc], c[pc] = a[pc + 1], b[pc + 1], c[pc + 1]
            pc += 2
            continue
        if H_ALU2_BASE <= h0 < H_ALU2_BASE + NUM_ALU2 and absorb2 and \
                h1 == H_RETURN and int(b[pc + 1]) == 1 and \
                h0 - H_ALU2_BASE not in div:
            hid[pc] = H_FUSE_A2R_BASE + h0 - H_ALU2_BASE
            pc += 2
            continue
        pc += 1
    return hid, a, b, c, ilo, ihi


_V_CLASSES = {CLS_V2: "v2", CLS_V1: "v1", CLS_VTEST: "vtest",
              CLS_VSHIFT: "vshift", CLS_VSPLAT: "vsplat",
              CLS_VEXTRACT: "vextract", CLS_VREPLACE: "vreplace"}
_SIMPLE = {CLS_NOP: ("nop",), CLS_CONST: ("const",), CLS_DROP: ("drop",),
           CLS_SELECT: ("select",), CLS_MEMSIZE: ("memsize",),
           CLS_VCONST: ("vconst",), CLS_VSHUFFLE: ("vshuffle",),
           CLS_VBITSEL: ("vbitsel",)}
_LOCAL = {CLS_LOCAL_GET: "lget", CLS_LOCAL_SET: "lset",
          CLS_LOCAL_TEE: "ltee"}


def fuse_blocks(hid, img):
    """Rewrite block-head hids to H_BLOCK_BASE + shape id
    (pallas_engine.py :429-569).

    Returns (hid', shapes): each shape is a tuple of op descriptors

      ("nop",) ("const",) ("drop",) ("select",) ("memsize",)
      ("lget", k) ("lset", k) ("ltee", k)   k = local ORDINAL (first-
      ("gget", k) ("gset", k)                occurrence rank in the block)
      ("alu2", sub) ("alu1", sub)            non-trapping subs only
      ("v2", sub) ("v1", sub) ("vtest", sub) ("vshift", sub)
      ("vsplat", sub) ("vextract", sub) ("vreplace", sub)
      ("vconst",) ("vshuffle",) ("vbitsel",)
      ("loadi", nbytes, flags) ("storei", nbytes)
      ("guardz",) ("guardnz",)               forward brz / brnz (nkeep 0)
      ("term", flat_hid)                     the non-pure op ending it

    Immediates and indices are read from the code planes at pc + offset;
    only local/global ordinals (which decide value forwarding) and ALU
    subs are part of a shape."""
    n = img.code_len
    targets = _targets(img)
    div = _DIV32_SUBS | _DIV64_SUBS

    def pure_desc(pc, lmap, gmap):
        cl = int(img.cls[pc])
        if cl in _SIMPLE:
            return _SIMPLE[cl]
        if cl in _LOCAL:
            return (_LOCAL[cl], lmap.setdefault(int(img.a[pc]), len(lmap)))
        if cl in (CLS_GLOBAL_GET, CLS_GLOBAL_SET):
            k = gmap.setdefault(int(img.a[pc]), len(gmap))
            return ("gget" if cl == CLS_GLOBAL_GET else "gset", k)
        if cl == CLS_ALU2:
            sub = int(img.sub[pc])
            return None if sub in div else ("alu2", sub)
        if cl == CLS_ALU1:
            sub = int(img.sub[pc])
            return None if laneops.alu1_traps(sub) else ("alu1", sub)
        if cl in _V_CLASSES:
            return (_V_CLASSES[cl], int(img.sub[pc]))
        if cl == CLS_LOAD:
            return ("loadi", int(img.b[pc]), int(img.c[pc]))
        if cl == CLS_STORE:
            return ("storei", int(img.b[pc]))
        if cl == CLS_BRZ and int(img.a[pc]) > pc:
            return ("guardz",)
        if cl == CLS_BRNZ and int(img.a[pc]) > pc and int(img.b[pc]) == 0:
            return ("guardnz",)
        return None

    hid = np.array(hid, copy=True)
    shapes = []
    shape_ids = {}
    pc = 0
    while pc < n:
        lmap, gmap = {}, {}
        ops = []
        j = pc
        while (j < n and len(ops) < MAX_BLOCK_LEN - 1
               and (j == pc or j not in targets)):
            d = pure_desc(j, lmap, gmap)
            if d is None:
                break
            ops.append(d)
            j += 1
        # the stopping op is the terminal unless the run stopped at a pure
        # op (a jump target starts its own block)
        term = None
        if ops and j < n and pure_desc(j, {}, {}) is None:
            term = ("term", int(hid[j]))
            j += 1
        shape = tuple(ops) + ((term,) if term else ())
        if len(shape) >= 2 and (shape in shape_ids
                                or len(shapes) < MAX_BLOCK_SHAPES):
            sid = shape_ids.setdefault(shape, len(shapes))
            if sid == len(shapes):
                shapes.append(shape)
            hid[pc] = H_BLOCK_BASE + sid
            pc = j
        else:
            pc += 1
    return hid, tuple(shapes)


def fused_lengths(hid, shapes) -> np.ndarray:
    """Instructions a fused dispatch at each pc retires when it runs in
    full (a block's ops plus its terminal; a superinstruction's 2-4), 0
    at every other pc."""
    hid = np.asarray(hid)
    out = np.zeros(hid.shape[0], np.int32)
    for pc, h in enumerate(hid.tolist()):
        if h >= H_BLOCK_BASE:
            out[pc] = len(shapes[h - H_BLOCK_BASE])
        else:
            fam = super_family(h)
            if fam is not None:
                out[pc] = 2 if fam[1] is None else SUPER_LEN[fam[0]]
    return out
