"""Generator of a module's fused dispatch: CUDA C++ for B2 blocks and B6 superinstructions.

The Pallas kernel compiles one handler per block shape of a module while
it traces (`mk_block`, wasmedge_tpu/batch/pallas_engine.py :2758-3201),
with a virtual stack resolved at trace time (`VS`, :2779-2818).  Its
counterpart here resolves the virtual stack when the code is generated:
`cuda_source` writes, for every block shape and superinstruction id of
the module's fused hid plane, one `case` of `Fused::step` whose stack
cells are variables of straight-line code (registers, not a dynamically
indexed array).  The source includes `csrc/interp.cu` and
`csrc/fused.cuh`; `batch/interp.py` builds it into the module's own
shared library.  The text depends only on the shapes, the superinstruction
ids present, the kBulk/kSimd/kWin/kOpt flags (kWin: memory through the
window cache, `csrc/memwin.cuh`; kOpt: optimistic convergence,
`csrc/optimistic.cuh`) and whether the stack splits between shared and
global memory (WASM_STACK_SPLIT), so equal modules share a build.

What a case does, per op (its operands from the code planes at pc0 + j):
a push names a new cell; a pop takes the top cell, or reads the row below
the block's entry sp; local and global writes commit at once and are
forwarded to later reads of the same ordinal; guards, inline loads and
stores exit with the cells live at that point written to their rows; at
the end the live cells are written and the terminal (if any) is left to
the per-op code.  Every decision (a guard's condition, an inline access's
address, a superinstruction's branch) goes through the warp's `w`, which
under kOpt takes lane 0's; an inline access that asks for a commit
(OPT_DEFER) exits before it with the ops ahead of it retired.  `batch/interp_ref.py` runs the same shapes op by op
with the same flush rule.
"""

from __future__ import annotations

from wasmedge_tpu_torch.batch.fusion import (
    H_BLOCK_BASE, SUPER_LEN, super_family)
from wasmedge_tpu_torch.batch.interp import (
    H_FUSE_A2R_BASE, H_FUSE_GBR, H_FUSE_GCA_BASE, H_FUSE_GCB_BASE,
    H_FUSE_GCC_BASE, H_FUSE_GCS_BASE, H_FUSE_GGA_BASE, H_FUSE_GGBNZ_BASE,
    H_FUSE_GGBZ_BASE, H_FUSE_GGS_BASE)

_HEAD = """\
// Generated by wasmedge_tpu_torch/batch/fusegen.py: the fused dispatch of
// one module ({nblocks} block shapes, {nsuper} superinstruction ids,
// kBulk = {bulk}, kSimd = {simd}, kWin = {win}, kOpt = {opt}, stack split
// {split}).  Built into _build/ at first use.
#define WASM_FUSED_BUILD 1
#define WASM_STACK_SPLIT {split}
#define ALU_INLINE __forceinline__
#include "interp.cu"
#include "fused.cuh"

namespace {{

struct Fused {{
  static constexpr bool kOn = true;
  // One fused dispatch at pc; returns true when the terminal op at the new
  // pc is left to the per-op code.  n: instructions retired; trap: set
  // when an op inside traps (pc and sp are then that op's own), or
  // OPT_DEFER when an inline access asks for a commit first (pc and sp
  // are that op's, n the ops before it).  m: the lane's memory access
  // (its window cache with kWin); w: the warp's decisions.
  template <bool kSimd, bool kWin, class Wp>
  __device__ static __forceinline__ bool step(
      const Params& p, const Lane<kSimd>& s, Mem<kWin>& m, Wp& w, int h,
      int& pc, int& sp, const int fp, const int ob, const int pages, int& n,
      int& trap) {{
    const int pc0 = pc, sp0 = sp;
    (void)sp0;
    (void)ob;
    (void)pages;
    (void)m;
    (void)w;
    switch (h) {{
"""

_TAIL = """\
      default:
        break;
    }}
    n = 0;
    trap = E_EXEC_FAILED;  // no fused id of this module
    return false;
  }}
}};

}}  // namespace

WASM_FUSED_LAUNCH({bulk}, {simd}, {win}, {opt}, Fused)
"""


def cuda_source(hid, shapes, bulk: bool, simd: bool,
                win: bool = False, opt: bool = False,
                split: bool = True) -> str:
    """The CUDA source of the fused dispatch for a fused hid plane and
    its block shapes (deterministic); `split`: the build for stacks
    deeper than the rows on chip (csrc/interp.cu WASM_STACK_SPLIT)."""
    supers = sorted({int(h) for h in hid if super_family(int(h))})
    flags = dict(bulk=str(bool(bulk)).lower(), simd=str(bool(simd)).lower(),
                 win=str(bool(win)).lower(), opt=str(bool(opt)).lower())
    out = [_HEAD.format(nblocks=len(shapes), nsuper=len(supers),
                        split=int(bool(split)), **flags)]
    for sid, shape in enumerate(shapes):
        out.append(_Block(shape, simd).case(H_BLOCK_BASE + sid))
    for h in supers:
        out.append(_super_case(h))
    out.append(_TAIL.format(**flags))
    return "".join(out)


class _Block:
    """Code of one block shape.  A cell is (name, kind): kind "s" a u64
    scalar (e2/e3 zero when written), "v" a V4 (kSimd builds: what a
    local.get, a row below the entry sp or a v128 op gives)."""

    def __init__(self, shape, simd):
        self.simd = simd
        self.term = shape[-1][0] == "term"
        self.ops = shape[:-1] if self.term else shape
        self.lines = []
        self.items = []      # the virtual stack above the rows below
        self.nbelow = 0      # rows below the entry sp popped so far
        self.below = {}      # k -> cell read from row sp0 - 1 - k
        self.pend_l = {}     # local ordinal -> cell last written
        self.pend_g = {}     # global ordinal -> scalar cell last written
        self.k = 0
        self.shape = shape

    # -- cells ---------------------------------------------------------------
    def new(self, kind, expr):
        name = f"c{self.k}"
        self.k += 1
        ty = "V4" if kind == "v" else "u64"
        self.emit(f"const {ty} {name} = {expr};")
        return name, kind

    def emit(self, line):
        self.lines.append("        " + line)

    def full_kind(self):
        return "v" if self.simd else "s"

    def read_below(self, k):
        if k not in self.below:
            fn = "get4" if self.simd else "get"
            self.below[k] = self.new(self.full_kind(),
                                     f"s.{fn}(sp0 - {1 + k})")
        return self.below[k]

    def pop(self):
        if self.items:
            return self.items.pop()
        cell = self.read_below(self.nbelow)
        self.nbelow += 1
        return cell

    def peek(self):
        if self.items:
            return self.items[-1]
        return self.read_below(self.nbelow)

    def drop(self):
        if self.items:
            self.items.pop()
        else:
            self.nbelow += 1

    def snapshot(self):
        return list(self.items), self.nbelow

    def flush_lines(self, snap):
        items, nbelow = snap
        out = []
        for i, (name, kind) in enumerate(items):
            fn = "put4" if kind == "v" else "put"
            out.append(f"s.{fn}({_sp0(i - nbelow)}, {name});")
        return out

    @staticmethod
    def sp_of(snap):
        items, nbelow = snap
        return _sp0(len(items) - nbelow)

    def exit_block(self, cond, snap, pc, sp, n, trap=None):
        body = self.flush_lines(snap) + [f"sp = {sp};", f"pc = {pc};",
                                         f"n = {n};"]
        if trap:
            body.append(f"trap = {trap};")
        body.append("return false;")
        self.emit(f"if ({cond}) {{")
        for line in body:
            self.emit("  " + line)
        self.emit("}")

    def access_exits(self, j, pre, call):
        """An inline load or store at op j: out of bounds, it exits with
        its trap, retired; asked to wait for a commit (kOpt), it exits
        before it with the j ops ahead of it retired."""
        r = f"r{self.k}"
        self.k += 1
        self.emit(f"const int {r} = {call};")
        at = f"pc0 + {j}"
        self.exit_block(f"{r} == E_MEM_OOB", pre, at, self.sp_of(pre),
                        j + 1, "E_MEM_OOB")
        self.exit_block(f"{r} == OPT_DEFER", pre, at, self.sp_of(pre), j,
                        "OPT_DEFER")

    # -- the shape -----------------------------------------------------------
    def case(self, h):
        for j, op in enumerate(self.ops):
            self.op(j, op)
        snap = self.snapshot()
        for line in self.flush_lines(snap):
            self.emit(line)
        nops = len(self.ops)
        self.emit(f"sp = {self.sp_of(snap)};")
        self.emit(f"pc = pc0 + {nops};")
        self.emit(f"n = {nops};")
        self.emit(f"return {'true' if self.term else 'false'};")
        desc = " ".join(":".join(str(x) for x in op) for op in self.shape)
        return (f"      case {h}: {{  // {desc}\n"
                + "\n".join(self.lines) + "\n      }\n")

    def op(self, j, op):
        kind = op[0]
        at = f"pc0 + {j}"
        a = f"__ldg(&p.a[{at}])"
        if kind == "nop":
            return
        if kind == "const":
            self.items.append(self.new(
                "s", f"pack(__ldg(&p.ilo[{at}]), __ldg(&p.ihi[{at}]))"))
        elif kind == "lget":
            cell = self.pend_l.get(op[1])
            if cell is None:
                cell = self.new(self.full_kind(), f"s.getc(fp + {a})")
            self.items.append(cell)
        elif kind in ("lset", "ltee"):
            cell = self.pop() if kind == "lset" else self.peek()
            fn = "put4" if cell[1] == "v" else "put"
            self.emit(f"s.{fn}(fp + {a}, {cell[0]});")
            self.pend_l[op[1]] = cell
        elif kind == "gget":
            cell = self.pend_g.get(op[1])
            if cell is None:
                cell = self.new("s", f"fused_gget(p, s, {a})")
            self.items.append(cell)
        elif kind == "gset":
            name, ck = self.pop()
            cell = (name, ck) if ck == "s" else self.new("s", f"lo64({name})")
            self.emit(f"fused_gset(p, s, {a}, {cell[0]});")
            self.pend_g[op[1]] = cell
        elif kind == "drop":
            self.drop()
        elif kind == "select":
            cnd, x2, x1 = self.pop(), self.pop(), self.pop()
            test = f"(u32)lo64({cnd[0]}) == 0"
            if x1[1] == "s" and x2[1] == "s":
                self.items.append(self.new(
                    "s", f"{test} ? {x2[0]} : {x1[0]}"))
            else:
                self.items.append(self.new(
                    "v", f"{test} ? v4of({x2[0]}) : v4of({x1[0]})"))
        elif kind == "memsize":
            self.items.append(self.new("s", "cell32((u32)pages)"))
        elif kind == "alu2":
            y, x = self.pop(), self.pop()
            self.items.append(self.new(
                "s", f"fused_alu2({op[1]}, lo64({x[0]}), lo64({y[0]}))"))
        elif kind == "alu1":
            x = self.pop()
            self.items.append(self.new(
                "s", f"fused_alu1({op[1]}, lo64({x[0]}))"))
        elif kind in ("guardz", "guardnz"):
            cnd = self.pop()
            snap = self.snapshot()
            if kind == "guardz":
                self.exit_block(f"!w.nz((u32)lo64({cnd[0]}))", snap,
                                a, self.sp_of(snap), j + 1)
            else:
                self.exit_block(f"w.nz((u32)lo64({cnd[0]}))", snap, a,
                                f"ob + __ldg(&p.c[{at}])", j + 1)
        elif kind == "loadi":
            pre = self.snapshot()
            addr = self.pop()
            name = f"c{self.k}"
            self.k += 1
            self.emit(f"u64 {name};")
            self.access_exits(
                j, pre, f"fused_load(p, s, m, w, pages, "
                f"(u32)lo64({addr[0]}), (u32){a}, {op[1]}, {op[2]}, {name})")
            self.items.append((name, "s"))
        elif kind == "storei":
            pre = self.snapshot()
            val, addr = self.pop(), self.pop()
            self.access_exits(
                j, pre, f"fused_store(p, s, m, w, pages, "
                f"(u32)lo64({addr[0]}), (u32){a}, {op[1]}, "
                f"lo64({val[0]}))")
        else:
            self.v128_op(op, a)

    def v128_op(self, op, a):
        kind = op[0]
        if kind == "v2":
            y, x = self.pop(), self.pop()
            expr = f"v2_op({op[1]}, v4of({x[0]}), v4of({y[0]}))"
        elif kind == "v1":
            x = self.pop()
            expr = f"v1_op({op[1]}, v4of({x[0]}))"
        elif kind == "vtest":
            x = self.pop()
            self.items.append(self.new(
                "s", f"(u64)vtest_op({op[1]}, v4of({x[0]}))"))
            return
        elif kind == "vshift":
            cnt, x = self.pop(), self.pop()
            expr = (f"vshift_op({op[1]}, v4of({x[0]}), "
                    f"(u32)lo64({cnt[0]}))")
        elif kind == "vsplat":
            v = self.pop()
            expr = f"vsplat_op({op[1]}, lo64({v[0]}))"
        elif kind == "vextract":
            x = self.pop()
            self.items.append(self.new(
                "s", f"vextract_op({op[1]}, v4of({x[0]}), {a})"))
            return
        elif kind == "vreplace":
            v, x = self.pop(), self.pop()
            expr = (f"vreplace_op({op[1]}, v4of({x[0]}), {a}, "
                    f"lo64({v[0]}))")
        elif kind == "vconst":
            expr = f"fused_vrow(p, {a})"
        elif kind == "vshuffle":
            y, x = self.pop(), self.pop()
            expr = f"fused_vshuffle(p, {a}, v4of({x[0]}), v4of({y[0]}))"
        elif kind == "vbitsel":
            m, x, w = self.pop(), self.pop(), self.pop()
            expr = (f"fused_vbitsel(v4of({w[0]}), v4of({x[0]}), "
                    f"v4of({m[0]}))")
        else:
            raise ValueError(f"unknown block op {op}")
        self.items.append(self.new("v", expr))


def _sp0(k: int) -> str:
    return "sp0" if k == 0 else f"sp0 + {k}" if k > 0 else f"sp0 - {-k}"


# Superinstructions: operands from the rewritten planes fa ... fihi at the
# head slot.  Only images without v128 ops run them (two-word cells).
_FA = "__ldg(&p.fa[pc0])"
_FB = "__ldg(&p.fb[pc0])"
_FC = "__ldg(&p.fc[pc0])"
_FILO = "__ldg(&p.filo[pc0])"
_FIHI = "__ldg(&p.fihi[pc0])"
_GC = (f"s.get(fp + {_FA})", f"pack({_FILO}, {_FIHI})")  # local, imm
_GG = (f"s.get(fp + {_FA})", f"s.get(fp + {_FC})")       # local, local
_GGB = (f"s.get(fp + {_FILO})", f"s.get(fp + {_FIHI})")  # branch forms


def _super_case(h: int) -> str:
    base, sub = super_family(h)
    if base == H_FUSE_GBR:
        body = [f"const int nk = {_FB}, pt = {_FC};",
                f"if (nk == 1) s.putc(ob + pt, s.getc(fp + {_FILO}));",
                "sp = ob + pt + nk;", f"pc = {_FA};", "n = 2;",
                "return false;"]
        return _case(h, "GBR", body)
    n = SUPER_LEN[base]
    if base == H_FUSE_A2R_BASE:
        x, y = "s.get(sp0 - 2)", "s.get(sp0 - 1)"
    else:
        x, y = {H_FUSE_GGA_BASE: _GG, H_FUSE_GGS_BASE: _GG,
                H_FUSE_GGBZ_BASE: _GGB, H_FUSE_GGBNZ_BASE: _GGB}.get(
                    base, _GC)
    body = [f"const u64 r = fused_alu2({sub}, {x}, {y});"]
    if base in (H_FUSE_GCA_BASE, H_FUSE_GGA_BASE, H_FUSE_GCC_BASE):
        # the result is pushed; GCC leaves its call to the per-op code
        body += ["s.put(sp0, r);", "sp = sp0 + 1;", "pc = pc0 + 3;",
                 "n = 3;",
                 f"return {'true' if base == H_FUSE_GCC_BASE else 'false'};"]
        name = {H_FUSE_GCA_BASE: "GCA", H_FUSE_GGA_BASE: "GGA",
                H_FUSE_GCC_BASE: "GCC"}[base]
    elif base == H_FUSE_A2R_BASE:
        # the result goes where the return moves it; the return itself is
        # left to the per-op code, which finds it on top at fp
        body += ["s.put(fp, r);", "sp = fp + 1;", "pc = pc0 + 1;", "n = 1;",
                 "return true;"]
        name = "A2R"
    elif base in (H_FUSE_GCS_BASE, H_FUSE_GGS_BASE):
        body += [f"s.put(fp + {_FB}, r);", "pc = pc0 + 4;", "n = 4;",
                 "return false;"]
        name = "GCS" if base == H_FUSE_GCS_BASE else "GGS"
    elif base in (H_FUSE_GCB_BASE, H_FUSE_GGBZ_BASE):
        tgt = _FB if base == H_FUSE_GCB_BASE else _FA
        body += [f"pc = !w.nz((u32)r) ? {tgt} : pc0 + 4;", "n = 4;",
                 "return false;"]
        name = "GCB" if base == H_FUSE_GCB_BASE else "GGBZ"
    else:
        assert base == H_FUSE_GGBNZ_BASE
        body += ["if (w.nz((u32)r)) {",
                 f"  const int nk = {_FB}, pt = {_FC};",
                 "  if (nk == 1) s.putc(ob + pt, s.getc(sp0 - 1));",
                 "  sp = ob + pt + nk;", f"  pc = {_FA};",
                 "} else {", "  pc = pc0 + 4;", "}", "n = 4;",
                 "return false;"]
        name = "GGBNZ"
    assert len(body) and n in (2, 3, 4)
    return _case(h, f"{name} alu2:{sub}", body)


def _case(h, desc, body):
    return (f"      case {h}: {{  // {desc}\n"
            + "\n".join("        " + line for line in body) + "\n      }\n")
