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
literal targets, keep counts and callees; one that ends in
call_indirect, return_call or return_call_indirect runs it through
interp.cu's `call_op` (the per-op step's body); one that ends in a div
or rem runs it (its trap test decided here for a literal divisor) and,
if a lone call follows it (`chains`: the case's length counts it), a
direct one too, while any other call is left to the per-op code, which
runs it in the same turn; any other terminal is left to the per-op
code, as before.  Heads beyond the cap
keep a case per block shape in `Fused::step`, reached through the hid
plane, with its operands from the code planes at pc0 + j.  B6
superinstructions (`img` and their rewritten operand planes `sops`
given): one case of `Fused::at_pc` per superinstruction pc, up to the
same cap, dispatched by pc, every operand a literal (the local
offsets, the constant as one u64, the stored local, branch targets and
keep counts, the budget's length), GCC's direct call and A2R's return
run in the case through the B2 terminals' code; pcs beyond the cap keep
their id's case of `Fused::step`, reached through the hid plane.  With no
image, every block shape and superinstruction id has its case of
`Fused::step`, dispatched by hid (the form before instance cases, the
pc switch's yardstick).  The text depends on the
module, the kBulk/kSimd/kWin/kOpt flags (kWin: memory through the window
cache, `csrc/memwin.cuh`; kOpt: optimistic convergence,
`csrc/optimistic.cuh`), whether the stack splits between shared and
global memory (WASM_STACK_SPLIT) and the handlers compiled in on request
(WASM_TIER0, WASM_TABLES; WASM_GAS with weighted gas, where an instance
case tests the fuel against its ops' literal weight sum, so a lane
without the fuel for the whole block runs it per op and runs out on the
right one; the table and segment classes end a block and run per op).

What a block does, per op: a push names a new cell; a pop takes the top
cell, or reads the row below the block's entry sp; local and global
writes commit at once and are forwarded to later reads of the same
ordinal; v128 ops are force-inlined bodies chosen by their literal sub
(`v2_fn`, `v1_fn`, ...: no out-of-line `v2_op` / `v1_op` call); guards,
inline loads and stores exit with the cells live at that point written to
their rows; at the end the live cells are written, and then the terminal
runs (a div or rem also writes its result row, and a call its frame row,
its slid arguments and zeroed locals, as the per-op steps do).  Every
decision (a guard's or branch's condition, an inline access's address, a
return's frame row, a superinstruction's branch) goes through the warp's
`w`, which under kOpt takes lane 0's; an inline access
that asks for a commit (OPT_DEFER) exits before it with the ops ahead of
it retired.  `batch/interp_ref.py` runs the same shapes op by op with the
same flush rule, and its per-op step runs the terminal.
"""

from __future__ import annotations

import re

from wasmedge_tpu_torch.batch.fusion import (
    _DIV32_SUBS, _DIV64_SUBS, H_BLOCK_BASE, super_family)
from wasmedge_tpu_torch.batch.interp import (
    H_ALU2_BASE, H_BR, H_BRNZ, H_CALL, H_CALL_INDIRECT, H_FUSE_A2R_BASE,
    H_FUSE_GBR, H_FUSE_GCA_BASE, H_FUSE_GCB_BASE, H_FUSE_GCC_BASE,
    H_FUSE_GCS_BASE, H_FUSE_GGA_BASE, H_FUSE_GGBNZ_BASE, H_FUSE_GGBZ_BASE,
    H_FUSE_GGS_BASE, H_RETCALL, H_RETCALL_INDIRECT, H_RETURN)

# Instance cases per build.  Each is straight-line code inlined into the
# dispatch loop (twice under kOpt: the warp-leader and the careful loop),
# so the cap bounds a build's instruction footprint and nvcc time for a
# large module (1,024 cases: 1.7 MB of SASS and 145 s of nvcc for a kOpt
# build on an H100's host, PERF.md); the heads beyond it keep their
# shape's case.  A module of the spec corpus or of the benchmarks has at
# most 96 heads.
MAX_INSTANCE_CASES = 1024

# the call family, and the div and rem ops (the only ALU2 ops that end a
# block: they can trap).  A call chained after a div or rem runs in the
# per-op code, in the same turn: inlined in every case, it ran once per
# case a divergent warp held (the loop's top reconverges a warp every
# turn), and the divergent tail dispatch took 45 % longer on an H100
# (PERF.md).
_CALLS = (H_CALL, H_CALL_INDIRECT, H_RETCALL, H_RETCALL_INDIRECT)
_DIVS = frozenset(H_ALU2_BASE + sub for sub in _DIV32_SUBS | _DIV64_SUBS)
_DIV_S = (H_ALU2_BASE + 3, H_ALU2_BASE + 28)  # i32.div_s, i64.div_s
_TERM_NAMES = {H_BR: "br", H_BRNZ: "brnz", H_RETURN: "return",
               H_CALL: "call", H_CALL_INDIRECT: "call_indirect",
               H_RETCALL: "return_call",
               H_RETCALL_INDIRECT: "return_call_indirect"}

# terminals an instance case runs itself (no block ends in a brz: it
# comes only from `if`, always forward, and the planner makes every such
# brz a guard); a div or rem among them also runs a lone call at the
# next pc (`chains`)
_IN_CASE_TERMINALS = frozenset((H_BR, H_BRNZ, H_RETURN) + _CALLS) | _DIVS

_HEAD = """\
// Generated by wasmedge_tpu_torch/batch/fusegen.py: the fused dispatch of
// one module ({ninst} instance cases, {nblocks} block shape cases,
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
  // The dispatch at the clamped pc pcc (kByPc), with `left` steps of the
  // launch and `fuel` left: a block head's or a superinstruction's
  // instance case, else by the hid plane; returns the handler the
  // per-op code runs at pc next (after the n ops retired here), or
  // FUSED_DONE.  trap as for step.
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

# a superinstruction build's default: the hid of a pc that is no
# superinstruction's head goes to the per-op code
_NOT_SUPER = ("if ((unsigned)(h - H_FUSE_GCA_BASE) > "
              "(unsigned)(H_FUSE_GBR - H_FUSE_GCA_BASE))\n"
              "          return h;")

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
                hid0=None, a3: bool = False, cost=None, sops=None) -> str:
    """The CUDA source of the fused dispatch for a fused hid plane and
    its block shapes (deterministic); `split`: the build for stacks
    deeper than the rows on chip (csrc/interp.cu WASM_STACK_SPLIT); `t0`:
    the build with the tier-0 handlers (WASM_TIER0, defined only then);
    `a3`: with the table, segment and tail-call handlers (WASM_TABLES);
    `cost`: each pc's gas weight (weighted gas, WASM_GAS), None for flat
    gas.  With the image `img` and its original hid plane `hid0`, the
    block heads of a "blocks" encoding, or the superinstructions of a
    "super" one (`sops`: its rewritten operand planes fa ... fihi), get
    instance cases dispatched by pc."""
    hid = [int(h) for h in hid]
    chain = chains(hid, hid0, shapes) if img is not None and sops is None \
        else {}
    if img is None:
        heads = []
    elif sops is None:
        heads = [pc for pc, h in enumerate(hid) if h >= H_BLOCK_BASE]
    else:
        heads = [pc for pc, h in enumerate(hid) if super_family(h)]
    inst, rest = heads[:MAX_INSTANCE_CASES], heads[MAX_INSTANCE_CASES:]
    if img is None:
        sids, supers = range(len(shapes)), sorted(
            {h for h in hid if super_family(h)})
    elif sops is None:
        sids, supers = sorted({hid[pc] - H_BLOCK_BASE for pc in rest}), []
    else:
        sids, supers = [], sorted({hid[pc] for pc in rest})
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
            if sops is None:
                out.append(_Block(shapes[hid[pc] - H_BLOCK_BASE], simd,
                                  code, pc).instance_case(chain.get(pc)))
            else:
                out.append(_super_instance(code, sops, pc, hid[pc]))
        if not rest:
            default = _AT_PC_DEFAULT
        elif sops is None:
            default = _AT_PC_DEFAULT_STEP
        else:
            default = _AT_PC_DEFAULT_STEP.replace(
                "if (h < NUM_HANDLERS) return h;", _NOT_SUPER).replace(
                "a block head\n        // beyond the cap through its shape's "
                "case", "a\n        // superinstruction beyond the cap "
                "through its id's case")
        if cost is not None:
            default = default.replace("fuel <= len",
                                      "fuel <= gas_run(p, pcc, len)")
        out.append(default)
    out.append(_TAIL.format(**flags))
    return "".join(out)


def chains(hid, hid0, shapes) -> dict:
    """{head pc: the pc of the call it chains} over a blocks encoding
    (the fused hid plane `hid`, the original `hid0`): the instance heads
    (the first MAX_INSTANCE_CASES) whose block ends in a div or rem
    followed by a call, call_indirect, return_call or
    return_call_indirect that heads no block.  Such a case runs the
    terminal, and the call runs in the same turn of the loop
    (`_Block.div_terminal`); its fused length, in `Tables.flen` and its
    budget test, counts the call."""
    hid = [int(h) for h in hid]
    heads = [pc for pc, h in enumerate(hid)
             if h >= H_BLOCK_BASE][:MAX_INSTANCE_CASES]
    out = {}
    for pc in heads:
        shape = shapes[hid[pc] - H_BLOCK_BASE]
        th = shape[-1][1] if shape[-1][0] == "term" else None
        t1 = pc + len(shape)
        if th in _DIVS and th in _IN_CASE_TERMINALS and t1 < len(hid) \
                and int(hid0[t1]) in _CALLS and hid[t1] < H_BLOCK_BASE:
            out[pc] = t1
    return out


def terminal_counts(src: str) -> dict:
    """The terminals the instance cases of a generated source run in
    the case, by kind ("br", "brnz", "return", "call", "call_indirect",
    "return_call", "return_call_indirect", "div_rem"), and "chained":
    the lone calls their div or rem cases also run."""
    out = dict.fromkeys(list(_TERM_NAMES.values()) + ["div_rem", "chained"],
                        0)
    at = src.find("at_pc(")
    if at < 0:
        return out
    # a case that runs its terminal notes its rows below sp first
    for h, body in re.findall(r"^      case \d+: \{  //[^\n]* term:(-?\d+)\n"
                              r"(.*?)\n      \}\n", src[at:], re.M | re.S):
        if "\n        s.note(sp);\n" in body:
            h = int(h)
            out["div_rem" if h in _DIVS else _TERM_NAMES[h]] += 1
    out["chained"] = len(re.findall(r"^ +// chained call at \d+",
                                    src[at:], re.M))
    return out


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
        self.lits = {}       # cell name -> its literal value (a const)
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

    def instance_case(self, chain=None):
        """The case of the block headed at pc0: the budget test against
        its literal length (else the head's own op), its ops, and its
        terminal in the case or left to the per-op code; `chain`: the pc
        of the lone call the case runs after its div or rem terminal
        (`chains`), counted in the length."""
        nops, pc0 = len(self.ops), self.pc0
        length = len(self.shape) + (chain is not None)
        self.emit(f"if (left < {length} || (p.fuel_on && fuel <= "
                  f"{self.code.gas(pc0, length)}))")
        self.emit(f"  return {int(self.code.hid0[pc0])};")
        self.emit("const int sp0 = sp;")
        snap = self.body()
        self.emit(f"sp = {self.sp_of(snap)};")
        t = pc0 + nops
        th = self.shape[-1][1] if self.term else None
        if th in _DIVS and th in _IN_CASE_TERMINALS:
            self.emit("s.note(sp);")
            self.div_terminal(th, t, snap, chain)
        elif th in _IN_CASE_TERMINALS:
            # the live cells are in their rows; rows below this sp hold
            # what the terminal's per-op step would read
            self.emit("s.note(sp);")
            if th in _CALLS[1:]:
                self.call_op_terminal(th, t, self.cell_at(0, snap)[1], nops)
            else:
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

    def scalar_at(self, k, snap):
        """(expression of the k-th cell's 64 scalar bits, its literal
        value or None)."""
        items, nbelow = snap
        if k < len(items):
            name = items[-1 - k][0]
            return f"lo64({name})", self.lits.get(name)
        return f"s.get({_sp0(len(items) - nbelow - 1 - k)})", None

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
            self.direct_call(a, t)

    def direct_call(self, a, t):
        """A direct call of callee a at pc t, its callee's entry, frame
        and locals literals."""
        c, emit = self.code, self.emit
        entry, npar, nloc, ftop = c.func(a)
        zeros = min(max(nloc - npar, 0), int(c.img.max_local_zeros))
        emit(f"const int fp_new = sp - {npar};")
        # a call that runs out of both stacks traps E_STACK_OVERFLOW, as
        # the per-op step and the reference decide
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

    def call_op_terminal(self, h, t, index, n):
        """call_indirect, return_call or return_call_indirect at pc t after
        n ops of the case, through interp.cu's `call_op` (the per-op
        step's body) with its type index or callee, table size and base
        literals and its table index `index` (an expression: a register or
        the row below sp).  On a trap pc and sp are the op's own."""
        c, emit = self.code, self.emit
        indirect = h in (H_CALL_INDIRECT, H_RETCALL_INDIRECT)
        tail = h in (H_RETCALL, H_RETCALL_INDIRECT)
        emit("int npc, nfp, nob, nsp, ncd;")
        emit(f"const int code = call_op<kSimd>(p, s, w, os, CallLit{{"
             f"{c.at('b', t)}, {c.at('c', t)}, "
             f"{index if indirect else '0u'}}}, {str(indirect).lower()}, "
             f"{str(tail).lower()}, {c.at('a', t)}, {t}, sp, fp, ob, cd, "
             f"npc, nfp, nob, nsp, ncd);")
        emit("if (code != 0) {")
        emit(f"  pc = {t};")
        emit("  trap = code;")
        emit("} else {")
        emit("  pc = npc;")
        emit("  fp = nfp;")
        emit("  ob = nob;")
        emit("  sp = nsp;")
        emit("  cd = ncd;")
        emit("}")
        emit(f"n = {n + 1};")
        emit("return FUSED_DONE;")

    def div_terminal(self, th, t, snap, chain):
        """A div or rem at pc t: its result written to its row (on a trap
        too, as the per-op step writes it), then its trap test: none for
        a literal divisor that cannot trap, always E_DIV_ZERO for a
        literal 0, the per-op test and its agreement otherwise (div_s by
        a literal -1 keeps it for INT_MIN).  Then pc t + 1, or the lone
        call there (`chain`): a direct call in the case, any other left
        to the per-op code, which runs it in the same turn."""
        emit, nops = self.emit, len(self.ops)
        sub = th - H_ALU2_BASE
        y, lit = self.scalar_at(0, snap)
        x = self.scalar_at(1, snap)[0]
        ones = 0xFFFFFFFF if sub < 25 else (1 << 64) - 1  # -1, all bits
        if lit is not None:
            lit &= ones
        r = f"r{self.k}"
        self.k += 1
        emit(f"int {r}t = 0;")
        emit(f"const u64 {r} = alu2({sub}, {x}, {y}, {r}t);")
        emit(f"s.put(sp - 2, {r});")
        done = [f"pc = {t};", f"n = {nops + 1};", "return FUSED_DONE;"]
        if lit == 0:
            for line in done[:1] + ["trap = E_DIV_ZERO;"] + done[1:]:
                emit(line)
            return
        if lit is None or (th in _DIV_S and lit == ones):
            emit(f"{r}t = (int)w.agree((u32){r}t);")
            emit(f"if ({r}t != 0) {{")
            for line in done[:1] + [f"trap = {r}t;"] + done[1:]:
                emit("  " + line)
            emit("}")
        emit("sp = sp - 1;")
        if chain is None:
            emit(f"pc = {t + 1};")
            emit(f"n = {nops + 1};")
            emit("return FUSED_DONE;")
            return
        h1 = int(self.code.hid0[chain])
        emit(f"// chained call at {chain}: {h1}")
        if h1 != H_CALL:
            # the per-op code runs it in this turn, once for every lane of
            # the warp at a call (_CALLS)
            emit(f"pc = {chain};")
            emit(f"n = {nops + 1};")
            emit(f"return {h1};")
            return
        self.direct_call(self.code.at("a", chain), chain)
        emit(f"n = {nops + 2};")
        emit("return FUSED_DONE;")

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
            cell = self.new("s", expr)
            if self.code is not None:
                self.lits[cell[0]] = (hi << 32) | lo
            self.items.append(cell)
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


# Superinstructions: a shape case (`Fused::step`, by the fused id) takes
# its operands from the rewritten planes fa ... fihi at the head slot; an
# instance case (`Fused::at_pc`, by the pc) has them as literals.  Only
# images without v128 ops run them (two-word cells).
_SUPER_PLANES = ("fa", "fb", "fc", "filo", "fihi")
_M32 = 0xFFFFFFFF
_SUPER_NAMES = {H_FUSE_GCA_BASE: "GCA", H_FUSE_GCB_BASE: "GCB",
                H_FUSE_A2R_BASE: "A2R", H_FUSE_GCC_BASE: "GCC",
                H_FUSE_GCS_BASE: "GCS", H_FUSE_GGA_BASE: "GGA",
                H_FUSE_GGS_BASE: "GGS", H_FUSE_GGBZ_BASE: "GGBZ",
                H_FUSE_GGBNZ_BASE: "GGBNZ", H_FUSE_GBR: "GBR"}


def _super_lines(h, lit=None):
    """(lines, n, terminal) of superinstruction h: the lines compute and
    write what it writes and set sp and pc (`sp0` and `pc0` its entry's);
    n is the ops it retires before its terminal, which is the per-op
    code's or an instance case's to run (H_CALL after GCC, H_RETURN after
    A2R, else None).  `lit`: None (operands loaded from the rewritten
    planes at pc0) or {plane: int} (an instance case's literals, pc0 its
    literal pc)."""
    base, sub = super_family(h)
    if lit is None:
        op = {k: f"__ldg(&p.{k}[pc0])" for k in _SUPER_PLANES}
        imm = f"pack({op['filo']}, {op['fihi']})"
        pc0 = "pc0"
    else:
        op = {k: str(v) for k, v in lit.items()}
        imm = f"0x{((lit['fihi'] & _M32) << 32) | (lit['filo'] & _M32):016x}ull"
        pc0 = lit["pc"]

    def at(k):
        return f"pc0 + {k}" if lit is None else str(pc0 + k)

    def keep(src, ind=""):
        # a branch's kept value and its sp: nk and pt at run time, or
        # folded when they are literals
        if lit is None:
            return [f"{ind}const int nk = {op['fb']}, pt = {op['fc']};",
                    f"{ind}if (nk == 1) s.putc(ob + pt, {src});",
                    f"{ind}sp = ob + pt + nk;"]
        nk, pt = lit["fb"], lit["fc"]
        return ([f"{ind}s.putc(ob + {pt}, {src});"] if nk == 1 else []) + \
            [f"{ind}sp = ob + {pt + nk};"]

    if base == H_FUSE_GBR:
        return (keep(f"s.getc(fp + {op['filo']})") + [f"pc = {op['fa']};"],
                2, None)
    if base == H_FUSE_A2R_BASE:
        x, y = "s.get(sp0 - 2)", "s.get(sp0 - 1)"
    elif base in (H_FUSE_GGA_BASE, H_FUSE_GGS_BASE):
        x, y = f"s.get(fp + {op['fa']})", f"s.get(fp + {op['fc']})"
    elif base in (H_FUSE_GGBZ_BASE, H_FUSE_GGBNZ_BASE):
        x, y = f"s.get(fp + {op['filo']})", f"s.get(fp + {op['fihi']})"
    else:
        x, y = f"s.get(fp + {op['fa']})", imm
    body = [f"const u64 res = fused_alu2({sub}, {x}, {y});"]
    if base in (H_FUSE_GCA_BASE, H_FUSE_GGA_BASE, H_FUSE_GCC_BASE):
        # the result is pushed; GCC's call is its terminal
        body += ["s.put(sp0, res);", "sp = sp0 + 1;", f"pc = {at(3)};"]
        return body, 3, H_CALL if base == H_FUSE_GCC_BASE else None
    if base == H_FUSE_A2R_BASE:
        # the result goes where the return moves it; the return is its
        # terminal, which finds it on top at fp (an instance case's
        # return writes it there itself)
        return body + (["s.put(fp, res);"] if lit is None else []) + \
            ["sp = fp + 1;", f"pc = {at(1)};"], 1, H_RETURN
    if base in (H_FUSE_GCS_BASE, H_FUSE_GGS_BASE):
        return body + [f"s.put(fp + {op['fb']}, res);", f"pc = {at(4)};"], \
            4, None
    if base in (H_FUSE_GCB_BASE, H_FUSE_GGBZ_BASE):
        tgt = op["fb"] if base == H_FUSE_GCB_BASE else op["fa"]
        return body + [f"pc = !w.nz((u32)res) ? {tgt} : {at(4)};"], 4, None
    assert base == H_FUSE_GGBNZ_BASE
    return body + ["if (w.nz((u32)res)) {"] + keep("s.getc(sp0 - 1)", "  ") + \
        [f"  pc = {op['fa']};", "} else {", f"  pc = {at(4)};", "}"], 4, None


def _super_desc(h):
    base, sub = super_family(h)
    return _SUPER_NAMES[base] + ("" if sub is None else f" alu2:{sub}")


def _super_case(h: int) -> str:
    """The shape case of superinstruction id h in `Fused::step`: operands
    from the planes at pc0; returns true when its terminal (GCC's call,
    A2R's return) is left to the per-op code."""
    lines, n, term = _super_lines(h)
    return _case(h, _super_desc(h), lines + [
        f"n = {n};", f"return {'true' if term is not None else 'false'};"])


def _super_instance(code, sops, pc0, h):
    """The instance case of the superinstruction at pc0 in `Fused::at_pc`
    (its fused id h; `sops`: the rewritten planes fa ... fihi that
    `fuse_image` gave):
    the budget test against its literal length, its lines with every
    operand a literal, and GCC's call or A2R's return in the case, through
    `_Block`'s instance terminals (the per-op steps' semantics: C9's
    order, a frame row saved for a B3 rollback, agreed return rows)."""
    lit = {k: int(v[pc0]) for k, v in zip(_SUPER_PLANES, sops)}
    lit["pc"] = pc0
    lines, n, term = _super_lines(h, lit)
    length = n + (term is not None)
    blk = _Block((("nop",),), False, code, pc0)
    blk.emit(f"if (left < {length} || (p.fuel_on && fuel <= "
             f"{code.gas(pc0, length)}))")
    blk.emit(f"  return {int(code.hid0[pc0])};")
    if any("sp0" in line for line in lines):
        blk.emit("const int sp0 = sp;")
    for line in lines:
        blk.emit(line)
    t = pc0 + n
    if term is not None:
        # the terminal's rows below this sp hold what its per-op step
        # would read: GCC's pushed result, A2R's at fp
        blk.emit("s.note(sp);")
        if term == H_CALL:
            blk.direct_call(code.at("a", t), t)
        else:
            blk.terminal(H_RETURN, t, ([("res", "s")], 0))
    blk.emit(f"n = {length};")
    blk.emit("return FUSED_DONE;")
    desc = _super_desc(h) + ("" if term is None else f" term:{term}")
    return (f"      case {pc0}: {{  // {desc}\n"
            + "\n".join(blk.lines) + "\n      }\n")


def _case(h, desc, body):
    return (f"      case {h}: {{  // {desc}\n"
            + "\n".join("        " + line for line in body) + "\n      }\n")
