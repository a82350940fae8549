"""Generator of a module's fused dispatch: CUDA C++ for B2 blocks and B6 superinstructions.

The Pallas kernel compiles one handler per block shape of a module while
it traces (`mk_block`, wasmedge_tpu/batch/pallas_engine.py :2758-3201),
with a virtual stack resolved at trace time (`VS`, :2779-2818).  Its
counterpart here resolves the virtual stack when the code is generated,
so a block's cells are variables of straight-line code (registers, not a
dynamically indexed array).  The source includes `csrc/interp.cu` and
`csrc/fused.cuh`; `batch/interp.py` builds it into the module's own
shared library, keyed by the text.

B2 blocks (`img` given): one `case` of `Fused::at_pc` per block *head
pc*, up to MAX_INSTANCE_CASES, with every immediate a literal (local
offsets, global ordinals, constants, access offsets, guard targets and
keep rows, the block's length and fall-through pc, v128 constants and
shuffle selectors), so an instance case reads no code plane.  The
interpreter switches on the pc (no hid or flen load); the case tests the
lane's step budget and fuel against its literal length and runs the
head's own op when they do not cover it.  A block that ends in br,
brnz, return or a direct call runs that terminal in the same case, with
literal targets, keep counts and callees; any other terminal is left to
the per-op code, as before.  Heads beyond the cap keep a case per block
shape in `Fused::step`, reached through the hid plane, with its operands
from the code planes at pc0 + j.  B6 superinstructions (`img` None): one
case of `Fused::step` per superinstruction id present, dispatched by hid.
The text depends on the module, the kBulk/kSimd/kWin/kOpt flags (kWin:
memory through the window cache, `csrc/memwin.cuh`; kOpt: optimistic
convergence, `csrc/optimistic.cuh`), whether the stack splits between
shared and global memory (WASM_STACK_SPLIT) and the handlers compiled in
on request (WASM_TIER0, WASM_TABLES; WASM_GAS with weighted gas, where an
instance case tests the fuel against its ops' literal weight sum, so a
lane without the fuel for the whole block runs it per op and runs out on
the right one; the table, segment and tail-call classes always end a
block and run per op).

What a block does, per op: a push names a new cell; a pop takes the top
cell, or reads the row below the block's entry sp; local and global
writes commit at once and are forwarded to later reads of the same
ordinal; v128 ops are force-inlined bodies chosen by their literal sub
(`v2_fn`, `v1_fn`, ...: no out-of-line `v2_op` / `v1_op` call); guards,
inline loads and stores exit with the cells live at that point written to
their rows; at the end the live cells are written, and then the terminal
runs.  Every decision (a guard's or branch's condition, an inline
access's address, a return's frame row, a superinstruction's branch) goes
through the warp's `w`, which under kOpt takes lane 0's; an inline access
that asks for a commit (OPT_DEFER) exits before it with the ops ahead of
it retired.  `batch/interp_ref.py` runs the same shapes op by op with the
same flush rule, and its per-op step runs the terminal.
"""

from __future__ import annotations

from wasmedge_tpu_torch.batch.fusion import (
    H_BLOCK_BASE, SUPER_LEN, super_family)
from wasmedge_tpu_torch.batch.interp import (
    H_BR, H_BRNZ, H_CALL, H_FUSE_A2R_BASE, H_FUSE_GBR,
    H_FUSE_GCA_BASE, H_FUSE_GCB_BASE, H_FUSE_GCC_BASE, H_FUSE_GCS_BASE,
    H_FUSE_GGA_BASE, H_FUSE_GGBNZ_BASE, H_FUSE_GGBZ_BASE, H_FUSE_GGS_BASE,
    H_RETURN)

# Instance cases per build.  Each is straight-line code inlined into the
# dispatch loop (twice under kOpt: the warp-leader and the careful loop),
# so the cap bounds a build's instruction footprint and nvcc time for a
# large module (1,024 cases: 1.7 MB of SASS and 145 s of nvcc for a kOpt
# build on an H100's host, PERF.md); the heads beyond it keep their
# shape's case.  A module of the spec corpus or of the benchmarks has at
# most 96 heads.
MAX_INSTANCE_CASES = 1024

# terminals an instance case runs itself (no block ends in a brz: it
# comes only from `if`, always forward, and the planner makes every such
# brz a guard)
_IN_CASE_TERMINALS = (H_BR, H_BRNZ, H_RETURN, H_CALL)

_HEAD = """\
// Generated by wasmedge_tpu_torch/batch/fusegen.py: the fused dispatch of
// one module ({ninst} block instance cases, {nblocks} block shape cases,
// {nsuper} superinstruction ids, kBulk = {bulk}, kSimd = {simd}, kWin =
// {win}, kOpt = {opt}, stack split {split}).  Built into _build/ at first
// use.
#define WASM_FUSED_BUILD 1
#define WASM_STACK_SPLIT {split}
{defines}#define ALU_INLINE __forceinline__
#include "interp.cu"
#include "fused.cuh"

namespace {{

struct Fused {{
  static constexpr bool kOn = true;
  static constexpr bool kByPc = {by_pc};
  // One fused dispatch at pc by its fused id h (a block shape beyond the
  // instance cap, a superinstruction); returns true when the terminal op
  // at the new pc is left to the per-op code.  n: instructions retired;
  // trap: set when an op inside traps (pc and sp are then that op's own),
  // or OPT_DEFER when an inline access asks for a commit first (pc and sp
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

_STEP_TAIL = """\
      default:
        break;
    }
    n = 0;
    trap = E_EXEC_FAILED;  // no fused id of this module
    return false;
  }
"""

_AT_PC_HEAD = """\
  // The dispatch at the clamped pc pcc (kByPc: B2 builds), with `left`
  // steps of the launch and `fuel` left: a block head's instance case,
  // else by the hid plane; returns the handler the per-op code runs at pc
  // next (after the n ops retired here), or FUSED_DONE.  trap as for
  // step.
  template <bool kSimd, bool kWin, class Wp>
  __device__ static __forceinline__ int at_pc(
      const Params& p, const Lane<kSimd>& s, Mem<kWin>& m, Wp& w,
      OptRun& os, const int pcc, const int left, const int fuel, int& pc,
      int& sp, int& fp, int& ob, int& cd, const int pages, int& n,
      int& trap) {
    (void)m;
    (void)os;
    (void)pages;
    switch (pcc) {
"""

_AT_PC_DEFAULT_STEP = """\
      default: {
        // a pc that heads no instance case: its hid, and a block head
        // beyond the cap through its shape's case
        const int h = __ldg(&p.hid[pcc]);
        if (h < NUM_HANDLERS) return h;
        const int len = __ldg(&p.flen[pcc]);
        if (left < len || (p.fuel_on && fuel <= len))
          return __ldg(&p.hid0[pcc]);
        if (!step<kSimd, kWin>(p, s, m, w, h, pc, sp, fp, ob, pages, n,
                               trap) || trap != 0)
          return FUSED_DONE;
        return __ldg(&p.hid[clampi(pc, 0, p.code_len - 1)]);
      }
    }
  }
"""

_AT_PC_DEFAULT = """\
      default:
        return __ldg(&p.hid[pcc]);
    }
  }
"""

_TAIL = """\
}};

}}  // namespace

WASM_FUSED_LAUNCH({bulk}, {simd}, {win}, {opt}, Fused)
"""


def cuda_source(hid, shapes, bulk: bool, simd: bool,
                win: bool = False, opt: bool = False,
                split: bool = True, t0: bool = False, img=None,
                hid0=None, a3: bool = False, cost=None) -> str:
    """The CUDA source of the fused dispatch for a fused hid plane and
    its block shapes (deterministic); `split`: the build for stacks
    deeper than the rows on chip (csrc/interp.cu WASM_STACK_SPLIT); `t0`:
    the build with the tier-0 handlers (WASM_TIER0, defined only then);
    `a3`: with the table, segment and tail-call handlers (WASM_TABLES);
    `cost`: each pc's gas weight (weighted gas, WASM_GAS), None for flat
    gas.  With the image `img` and its original hid plane `hid0` (a
    "blocks" encoding), the block heads get instance cases dispatched by
    pc."""
    hid = [int(h) for h in hid]
    supers = sorted({h for h in hid if super_family(h)})
    heads = [pc for pc, h in enumerate(hid) if h >= H_BLOCK_BASE] \
        if img is not None else []
    inst, rest = heads[:MAX_INSTANCE_CASES], heads[MAX_INSTANCE_CASES:]
    sids = sorted({hid[pc] - H_BLOCK_BASE for pc in rest}) \
        if img is not None else range(len(shapes))
    flags = dict(bulk=str(bool(bulk)).lower(), simd=str(bool(simd)).lower(),
                 win=str(bool(win)).lower(), opt=str(bool(opt)).lower())
    defines = "".join(f"#define {d} 1\n" for d, on in (
        ("WASM_TIER0", t0), ("WASM_TABLES", a3),
        ("WASM_GAS", cost is not None)) if on)
    out = [_HEAD.format(ninst=len(inst), nblocks=len(sids),
                        nsuper=len(supers), split=int(bool(split)),
                        defines=defines,
                        by_pc=str(img is not None).lower(), **flags)]
    for sid in sids:
        out.append(_Block(shapes[sid], simd).case(H_BLOCK_BASE + sid))
    for h in supers:
        out.append(_super_case(h))
    out.append(_STEP_TAIL)
    if img is not None:
        out.append(_AT_PC_HEAD)
        code = _Code(img, hid0, cost)
        for pc in inst:
            out.append(_Block(shapes[hid[pc] - H_BLOCK_BASE], simd,
                              code, pc).instance_case())
        default = _AT_PC_DEFAULT_STEP if sids else _AT_PC_DEFAULT
        if cost is not None:
            default = default.replace("fuel <= len",
                                      "fuel <= gas_run(p, pcc, len)")
        out.append(default)
    out.append(_TAIL.format(**flags))
    return "".join(out)


class _Code:
    """The image's planes an instance case takes its literals from, and
    each pc's gas weight (None: flat gas)."""

    def __init__(self, img, hid0, cost=None):
        self.img, self.hid0, self.cost = img, hid0, cost

    def gas(self, pc, n):
        """What n ops from pc cost: n, or their weights' sum."""
        if self.cost is None:
            return n
        return int(sum(int(c) for c in self.cost[pc:pc + n]))

    def at(self, plane, pc):
        return int(getattr(self.img, plane)[pc])

    def vrow(self, a):
        """v128 table row a, clamped as the kernel clamps it: four u32."""
        v = self.img.v128
        r = min(max(a, 0), v.shape[0] - 1)
        return [int(x) & 0xFFFFFFFF for x in v[r]]

    def func(self, a):
        """(entry, params, locals, frame top) of callee a, clamped."""
        img = self.img
        f = min(max(a, 0), len(img.f_entry) - 1)
        return (int(img.f_entry[f]), int(img.f_nparams[f]),
                int(img.f_nlocals[f]), int(img.f_frame_top[f]))


class _Block:
    """Code of one block: a shape case (operands from the code planes at
    pc0 + j, `code` None) or the instance case of the block headed at pc0
    (`code`: its literals).  A cell is (name, kind): kind "s" a u64
    scalar (e2/e3 zero when written), "v" a V4 (kSimd builds: what a
    local.get, a row below the entry sp or a v128 op gives)."""

    def __init__(self, shape, simd, code=None, pc0=None):
        self.simd = simd
        self.code, self.pc0 = code, pc0
        self.done = "false" if code is None else "FUSED_DONE"
        self.term = shape[-1][0] == "term"
        self.ops = shape[:-1] if self.term else shape
        self.lines = []
        self.items = []      # the virtual stack above the rows below
        self.nbelow = 0      # rows below the entry sp popped so far
        self.below = {}      # k -> cell read from row sp0 - 1 - k
        self.pend_l = {}     # local ordinal -> cell last read or written
        self.pend_g = {}     # global ordinal -> scalar cell last written
        self.k = 0
        self.shape = shape

    # -- operands ------------------------------------------------------------
    def pc_at(self, j):
        return f"pc0 + {j}" if self.code is None else str(self.pc0 + j)

    def imm(self, plane, j):
        """Operand `plane` ("a", "b", "c") of op j."""
        if self.code is None:
            return f"__ldg(&p.{plane}[pc0 + {j}])"
        return str(self.code.at(plane, self.pc0 + j))

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
        body.append(f"return {self.done};")
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
        at = self.pc_at(j)
        self.exit_block(f"{r} == E_MEM_OOB", pre, at, self.sp_of(pre),
                        j + 1, "E_MEM_OOB")
        self.exit_block(f"{r} == OPT_DEFER", pre, at, self.sp_of(pre), j,
                        "OPT_DEFER")

    # -- the shape -----------------------------------------------------------
    def desc(self):
        return " ".join(":".join(str(x) for x in op) for op in self.shape)

    def body(self):
        for j, op in enumerate(self.ops):
            self.op(j, op)
        snap = self.snapshot()
        for line in self.flush_lines(snap):
            self.emit(line)
        return snap

    def case(self, h):
        snap = self.body()
        nops = len(self.ops)
        self.emit(f"sp = {self.sp_of(snap)};")
        self.emit(f"pc = pc0 + {nops};")
        self.emit(f"n = {nops};")
        self.emit(f"return {'true' if self.term else 'false'};")
        return (f"      case {h}: {{  // {self.desc()}\n"
                + "\n".join(self.lines) + "\n      }\n")

    def instance_case(self):
        """The case of the block headed at pc0: the budget test against
        its literal length (else the head's own op), its ops, and its
        terminal in the case or left to the per-op code."""
        nops, pc0 = len(self.ops), self.pc0
        length = len(self.shape)
        self.emit(f"if (left < {length} || (p.fuel_on && fuel <= "
                  f"{self.code.gas(pc0, length)}))")
        self.emit(f"  return {int(self.code.hid0[pc0])};")
        self.emit("const int sp0 = sp;")
        snap = self.body()
        self.emit(f"sp = {self.sp_of(snap)};")
        t = pc0 + nops
        th = self.shape[-1][1] if self.term else None
        if th in _IN_CASE_TERMINALS:
            # the live cells are in their rows; rows below this sp hold
            # what the terminal's per-op step would read
            self.emit("s.note(sp);")
            self.terminal(th, t, snap)
            self.emit(f"n = {nops + 1};")
            self.emit("return FUSED_DONE;")
        else:
            self.emit(f"pc = {t};")
            self.emit(f"n = {nops};")
            self.emit(f"return {th if self.term else 'FUSED_DONE'};")
        return (f"      case {pc0}: {{  // {self.desc()}\n"
                + "\n".join(self.lines) + "\n      }\n")

    # -- terminals -----------------------------------------------------------
    def cell_at(self, k, snap):
        """The k-th cell from the top at the terminal (0: the top) as
        (expression of the whole cell, expression of its low 32 bits):
        a live cell's register, else its row below the entry sp."""
        items, nbelow = snap
        if k < len(items):
            name, kind = items[-1 - k]
            whole = f"v4of({name})" if self.simd and kind == "s" else name
            return whole, f"(u32)lo64({name})"
        row = _sp0(len(items) - nbelow - 1 - k)
        return f"s.getc({row})", f"(u32)s.get({row})"

    def terminal(self, th, t, snap):
        c = self.code
        a, b, cc = c.at("a", t), c.at("b", t), c.at("c", t)
        emit = self.emit
        if th == H_BR:
            if b == 1:
                emit(f"s.putc(ob + {cc}, {self.cell_at(0, snap)[0]});")
            emit(f"sp = ob + {cc + b};")
            emit(f"pc = {a};")
        elif th == H_BRNZ:
            emit(f"if (w.nz({self.cell_at(0, snap)[1]})) {{")
            if b == 1:
                emit(f"  s.putc(ob + {cc}, {self.cell_at(1, snap)[0]});")
            emit(f"  sp = ob + {cc + b};")
            emit(f"  pc = {a};")
            emit("} else {")
            emit("  sp = sp - 1;")
            emit(f"  pc = {t + 1};")
            emit("}")
        elif th == H_RETURN:
            if b == 1:
                emit(f"s.putc(fp, {self.cell_at(0, snap)[0]});")
            emit("if (cd == 0) {")
            emit(f"  sp = fp + {b};")
            emit(f"  pc = {t};")
            emit("  trap = TRAP_DONE;")
            emit("} else {")
            emit("  // where the return goes is a decision")
            emit("  const size_t r = s.at(cd - 1, p.CD);")
            emit("  pc = (int)w.agree((u32)p.fr_ret_pc[r]);")
            emit("  const int fp1 = (int)w.agree((u32)p.fr_fp[r]);")
            emit("  ob = (int)w.agree((u32)p.fr_opbase[r]);")
            emit(f"  sp = fp + {b};")
            emit("  fp = fp1;")
            emit("  cd = cd - 1;")
            emit("}")
        else:
            assert th == H_CALL
            entry, npar, nloc, ftop = c.func(a)
            zeros = min(max(nloc - npar, 0), int(c.img.max_local_zeros))
            emit(f"const int fp_new = sp - {npar};")
            # a call that runs out of both stacks traps E_STACK_OVERFLOW,
            # as the per-op step and the reference decide
            emit(f"if (fp_new + {ftop} > p.D) {{")
            emit(f"  pc = {t};")
            emit("  trap = E_STACK_OVERFLOW;")
            emit("} else if (cd >= p.CD - 1) {")
            emit(f"  pc = {t};")
            emit("  trap = E_CALL_STACK;")
            emit("} else {")
            emit("  if constexpr (Wp::kLead) opt_save_frame(p, s.lane, cd, "
                 "os.o.fhi);")
            emit("  const size_t r = s.at(cd, p.CD);")
            emit(f"  p.fr_ret_pc[r] = {t + 1};")
            emit("  p.fr_fp[r] = fp;")
            emit("  p.fr_opbase[r] = ob;")
            if zeros:
                emit(f"  for (int k = 0; k < {zeros}; ++k) "
                     f"s.put(fp_new + {npar} + k, 0);")
            emit(f"  pc = {entry};")
            emit("  fp = fp_new;")
            emit(f"  ob = fp_new + {nloc};")
            emit("  sp = ob;")
            emit("  cd = cd + 1;")
            emit("}")

    # -- ops -----------------------------------------------------------------
    def op(self, j, op):
        kind = op[0]
        a = self.imm("a", j)
        if kind == "nop":
            return
        if kind == "const":
            if self.code is None:
                expr = (f"pack(__ldg(&p.ilo[pc0 + {j}]), "
                        f"__ldg(&p.ihi[pc0 + {j}]))")
            else:
                lo = self.code.at("imm_lo", self.pc0 + j) & 0xFFFFFFFF
                hi = self.code.at("imm_hi", self.pc0 + j) & 0xFFFFFFFF
                expr = f"0x{(hi << 32) | lo:016x}ull"
            self.items.append(self.new("s", expr))
        elif kind == "lget":
            # a local read or written earlier in the block: that cell
            cell = self.pend_l.get(op[1])
            if cell is None:
                cell = self.new(self.full_kind(), f"s.getc(fp + {a})")
                self.pend_l[op[1]] = cell
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
                                f"ob + {self.imm('c', j)}", j + 1)
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
            expr = f"v2_fn({op[1]}, v4of({x[0]}), v4of({y[0]}))"
        elif kind == "v1":
            x = self.pop()
            expr = f"v1_fn({op[1]}, v4of({x[0]}))"
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
            if self.code is None:
                expr = f"fused_vrow(p, {a})"
            else:
                words = ", ".join(f"0x{w:08x}u"
                                  for w in self.code.vrow(int(a)))
                expr = f"V4{{{{{words}}}}}"
        elif kind == "vshuffle":
            y, x = self.pop(), self.pop()
            if self.code is None:
                expr = (f"fused_vshuffle(p, {a}, v4of({x[0]}), "
                        f"v4of({y[0]}))")
            else:
                xv, yv = self.new("v", f"v4of({x[0]})")[0], \
                    self.new("v", f"v4of({y[0]})")[0]
                words = ", ".join(_shuffle_word(xv, yv, mk)
                                  for mk in self.code.vrow(int(a)))
                expr = f"V4{{{{{words}}}}}"
        elif kind == "vbitsel":
            m, x, w = self.pop(), self.pop(), self.pop()
            expr = (f"fused_vbitsel(v4of({w[0]}), v4of({x[0]}), "
                    f"v4of({m[0]}))")
        else:
            raise ValueError(f"unknown block op {op}")
        self.items.append(self.new("v", expr))


def _shuffle_word(x: str, y: str, mk: int) -> str:
    """Word k of i8x16.shuffle with the literal selector word mk of the
    V4s x and y: interp.cu's shuffle_word folded when the code is
    generated, one __byte_perm per aligned 8-byte source pair that output
    bytes come from (selector bits 3-7 pick the pair, 0-2 the byte; a
    selector beyond the 32 bytes gives 0)."""
    pairs = ((x, 0), (x, 2), (y, 0), (y, 2))
    sel = [(mk >> (8 * j)) & 0xFF for j in range(4)]
    nib = sum((m & 7) << (4 * j) for j, m in enumerate(sel))
    terms = []
    for q, (v, w) in enumerate(pairs):
        mask = sum(0xFF << (8 * j) for j, m in enumerate(sel)
                   if (m >> 3) & 0x1F == q)
        if not mask:
            continue
        term = {0x3210: f"{v}.w[{w}]", 0x7654: f"{v}.w[{w + 1}]"}.get(
            nib, f"__byte_perm({v}.w[{w}], {v}.w[{w + 1}], 0x{nib:04x}u)")
        terms.append(term if mask == 0xFFFFFFFF
                     else f"({term} & 0x{mask:08x}u)")
    return " | ".join(terms) if terms else "0u"


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
