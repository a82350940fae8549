"""WebAssembly text format (WAT) compiler and WAST script parser.

A copy of `wasmedge_tpu/utils/wat.py`.  WasmEdge consumes the official
spec testsuite as wast-derived JSON fetched over the network; without a
network or wat2wasm the port carries its own text front-end: `parse_wat`
compiles a `(module ...)` form to the binary format via ModuleBuilder, and
`parse_wast` splits a spec script into the command stream that
`wasmedge_tpu_torch.spec` runs, after WasmEdge's SpecTest command model
(test/spec/spectest.cpp).

Coverage: the core-spec text subset — s-expr modules with type/import/
func/table/memory/global/export/start/elem/data fields, symbolic ids,
folded and unfolded instructions, block/loop/if labels, typeuses, memargs,
dec/hex int literals and dec/hex float literals (inf, nan, nan:0x..),
string escapes, v128 constants and lane immediates; script commands
module/register/invoke/assert_return/assert_trap/assert_exhaustion/
assert_invalid/assert_malformed/assert_unlinkable with `(module binary
...)` and `(module quote ...)`.  Not covered: multi-memory syntax sugar
beyond index 0.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from wasmedge_tpu_torch.utils.builder import ModuleBuilder, uleb

# ---------------------------------------------------------------------------
# tokenizer / s-expressions
# ---------------------------------------------------------------------------


class WatError(Exception):
    pass


class SExpr(list):
    pass


_TOKEN = re.compile(
    r'''\s*(?:
        (?P<lparen>\()
      | (?P<rparen>\))
      | (?P<string>"(?:\\.|[^"\\])*")
      | (?P<atom>[^\s()";]+)
    )''',
    re.VERBOSE,
)


def _strip_comments(src: str) -> str:
    out = []
    i = 0
    n = len(src)
    depth = 0
    while i < n:
        c = src[i]
        if depth == 0 and c == '"':
            j = i + 1
            while j < n:
                if src[j] == "\\":
                    j += 2
                    continue
                if src[j] == '"':
                    break
                j += 1
            out.append(src[i:j + 1])
            i = j + 1
            continue
        if src.startswith(";;", i) and depth == 0:
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if src.startswith("(;", i):
            depth += 1
            i += 2
            continue
        if src.startswith(";)", i) and depth > 0:
            depth -= 1
            i += 2
            continue
        if depth == 0:
            out.append(c)
        i += 1
    return "".join(out)


def tokenize(src: str) -> List[str]:
    src = _strip_comments(src)
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if not m:
            if src[pos:].strip() == "":
                break
            raise WatError(f"lex error at {pos}: {src[pos:pos+20]!r}")
        pos = m.end()
        for kind in ("lparen", "rparen", "string", "atom"):
            if m.group(kind):
                toks.append(m.group(kind))
                break
    return toks


def parse_sexprs(toks: List[str]) -> List[Union[str, SExpr]]:
    out: List[Union[str, SExpr]] = []
    stack: List[SExpr] = []
    for t in toks:
        if t == "(":
            stack.append(SExpr())
        elif t == ")":
            if not stack:
                raise WatError("unbalanced )")
            e = stack.pop()
            (stack[-1] if stack else out).append(e)
        else:
            (stack[-1] if stack else out).append(t)
    if stack:
        raise WatError("unbalanced (")
    return out


def parse_string(tok: str) -> bytes:
    assert tok.startswith('"') and tok.endswith('"')
    body = tok[1:-1]
    out = bytearray()
    i = 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.extend(c.encode("utf-8"))
            i += 1
            continue
        e = body[i + 1]
        if e == "n":
            out.append(0x0A)
        elif e == "t":
            out.append(0x09)
        elif e == "r":
            out.append(0x0D)
        elif e == '"':
            out.append(0x22)
        elif e == "'":
            out.append(0x27)
        elif e == "\\":
            out.append(0x5C)
        elif e == "u":
            j = body.index("}", i)
            out.extend(chr(int(body[i + 3:j], 16)).encode("utf-8"))
            i = j + 1
            continue
        elif re.match(r"[0-9a-fA-F]", e):
            out.append(int(body[i + 1:i + 3], 16))
            i += 3
            continue
        else:
            raise WatError(f"bad escape \\{e}")
        i += 2
    return bytes(out)


# ---------------------------------------------------------------------------
# literals
# ---------------------------------------------------------------------------


def parse_int(tok: str, bits: int) -> int:
    t = tok.replace("_", "")
    neg = t.startswith("-")
    if t.startswith(("+", "-")):
        t = t[1:]
    v = int(t, 16) if t.lower().startswith("0x") else int(t, 10)
    if neg:
        v = -v
    lo = -(1 << (bits - 1))
    hi = (1 << bits) - 1
    if not (lo <= v <= hi):
        raise WatError(f"int out of range for i{bits}: {tok}")
    return v & ((1 << bits) - 1)


def _parse_float(tok: str, is32: bool) -> int:
    """Float literal -> bit pattern (int)."""
    t = tok.replace("_", "")
    sign = 0
    if t.startswith(("+", "-")):
        sign = 1 if t[0] == "-" else 0
        t = t[1:]
    if t == "inf":
        bits = 0x7F800000 if is32 else 0x7FF0000000000000
    elif t == "nan":
        bits = 0x7FC00000 if is32 else 0x7FF8000000000000
    elif t.startswith("nan:"):
        payload = int(t[4:], 16) if t[4:].lower().startswith("0x") \
            else int(t[4:])
        if is32:
            bits = 0x7F800000 | payload
        else:
            bits = 0x7FF0000000000000 | payload
    else:
        if t.lower().startswith("0x"):
            # hex float; float.fromhex needs p-exponent
            ht = t if ("p" in t or "P" in t) else t + "p0"
            d = float.fromhex(ht)
        else:
            d = float(t)
        if is32:
            bits = struct.unpack("<I", struct.pack("<f", np.float32(d)))[0]
        else:
            bits = struct.unpack("<Q", struct.pack("<d", d))[0]
    if sign:
        bits |= 0x80000000 if is32 else 0x8000000000000000
    return bits


def parse_f32(tok: str) -> int:
    return _parse_float(tok, True)


def parse_f64(tok: str) -> int:
    return _parse_float(tok, False)


# ---------------------------------------------------------------------------
# module compiler
# ---------------------------------------------------------------------------

_VALTYPES = {"i32", "i64", "f32", "f64", "v128", "funcref", "externref"}

# ops whose immediate is a plain index resolved from an id space
_IDX_IMM = {
    "call": "func", "return_call": "func", "ref.func": "func",
    "local.get": "local", "local.set": "local", "local.tee": "local",
    "global.get": "global", "global.set": "global",
    "table.get": "table", "table.set": "table", "table.size": "table",
    "table.grow": "table", "table.fill": "table",
    "elem.drop": "elem", "data.drop": "data",
    "memory.init": "data",
    "br": "label", "br_if": "label",
}
# ops with a single byte lane immediate (SIMD extract/replace)
_LANE_IMM = {
    f"{s}.{k}"
    for s in ("i8x16", "i16x8")
    for k in ("extract_lane_s", "extract_lane_u", "replace_lane")
} | {
    f"{s}.{k}"
    for s in ("i32x4", "i64x2", "f32x4", "f64x2")
    for k in ("extract_lane", "replace_lane")
}

_V128_SHAPES = {"i8x16": (16, 8), "i16x8": (8, 16), "i32x4": (4, 32),
                "i64x2": (2, 64), "f32x4": (4, 32), "f64x2": (2, 64)}

_MEM_OPS = {
    "i32.load": 2, "i64.load": 3, "f32.load": 2, "f64.load": 3,
    "i32.load8_s": 0, "i32.load8_u": 0, "i32.load16_s": 1,
    "i32.load16_u": 1, "i64.load8_s": 0, "i64.load8_u": 0,
    "i64.load16_s": 1, "i64.load16_u": 1, "i64.load32_s": 2,
    "i64.load32_u": 2, "i32.store": 2, "i64.store": 3, "f32.store": 2,
    "f64.store": 3, "i32.store8": 0, "i32.store16": 1, "i64.store8": 0,
    "i64.store16": 1, "i64.store32": 2, "v128.load": 4, "v128.store": 4,
}


class _Func:
    def __init__(self):
        self.type_idx = None
        self.params: List[str] = []
        self.results: List[str] = []
        self.locals: List[str] = []
        self.names: Dict[str, int] = {}  # $id -> local index
        self.body: List = []
        self.export: List[str] = []
        self.import_mod: Optional[Tuple[str, str]] = None


class WatCompiler:
    """One (module ...) form -> wasm binary bytes."""

    def __init__(self, fields: SExpr):
        self.b = ModuleBuilder()
        self.type_names: Dict[str, int] = {}
        self.types: List[Tuple[tuple, tuple]] = []
        self.func_names: Dict[str, int] = {}
        self.global_names: Dict[str, int] = {}
        self.table_names: Dict[str, int] = {}
        self.mem_names: Dict[str, int] = {}
        self.elem_names: Dict[str, int] = {}
        self.data_names: Dict[str, int] = {}
        self.funcs: List[_Func] = []
        self.n_imported_funcs = 0
        self.n_imported_globals = 0
        self.n_globals = 0
        self.n_tables = 0
        self.n_mems = 0
        self.n_elems = 0
        self.n_datas = 0
        self.exports: List[Tuple[str, str, int]] = []
        self.start_idx = None
        self._collect(fields)

    # -- pass 1: collect fields, assign indices -------------------------
    def _collect(self, fields):
        pending = []
        for f in fields:
            if not isinstance(f, SExpr) or not f:
                raise WatError(f"bad module field {f}")
            kind = f[0]
            if kind == "type":
                self._field_type(f)
            else:
                pending.append(f)
        for f in pending:
            getattr(self, "_field_" + f[0].replace(".", "_"),
                    self._field_unknown)(f)
        self._emit()

    def _field_unknown(self, f):
        raise WatError(f"unsupported module field ({f[0]} ...)")

    def _typeuse_key(self, params, results):
        return (tuple(params), tuple(results))

    def _intern_type(self, params, results) -> int:
        key = self._typeuse_key(params, results)
        for i, t in enumerate(self.types):
            if t == key:
                return i
        self.types.append(key)
        return len(self.types) - 1

    def _field_type(self, f):
        # (type $name (func (param..) (result..)))
        i = 1
        name = None
        if i < len(f) and isinstance(f[i], str) and f[i].startswith("$"):
            name = f[i]
            i += 1
        ft = f[i]
        if not (isinstance(ft, SExpr) and ft and ft[0] == "func"):
            raise WatError("type: expected (func ...)")
        params, results, _ = self._parse_sig(ft[1:])
        idx = len(self.types)
        self.types.append(self._typeuse_key(params, results))
        if name:
            self.type_names[name] = idx

    def _parse_sig(self, items):
        """(param ...)* (result ...)* -> (params, results, names)."""
        params, results = [], []
        names = {}
        for it in items:
            if not isinstance(it, SExpr):
                raise WatError(f"bad sig item {it}")
            if it[0] == "param":
                if len(it) == 3 and it[1].startswith("$"):
                    names[it[1]] = len(params)
                    params.append(it[2])
                else:
                    params.extend(it[1:])
            elif it[0] == "result":
                results.extend(it[1:])
            else:
                raise WatError(f"bad sig item {it[0]}")
        return params, results, names

    def _split_typeuse(self, items):
        """Leading (type)/(param)/(result) run -> (ti, params, results,
        names, rest)."""
        i = 0
        explicit = None
        sig_items = []
        while i < len(items) and isinstance(items[i], SExpr) and \
                items[i] and items[i][0] in ("type", "param", "result"):
            it = items[i]
            if it[0] == "type":
                explicit = self._resolve(it[1], self.type_names)
            else:
                sig_items.append(it)
            i += 1
        params, results, names = self._parse_sig(sig_items)
        if explicit is not None:
            tp, tr = self.types[explicit]
            if not params and not results:
                params, results = list(tp), list(tr)
            ti = explicit
        else:
            ti = self._intern_type(params, results)
        return ti, params, results, names, items[i:]

    def _resolve(self, tok, names: Dict[str, int]) -> int:
        if isinstance(tok, str) and tok.startswith("$"):
            if tok not in names:
                raise WatError(f"unknown id {tok}")
            return names[tok]
        return int(tok)

    def _inline_export_import(self, f, i):
        """Parse (export "n")* (import "m" "n")? prefix at position i."""
        exports = []
        imp = None
        while i < len(f) and isinstance(f[i], SExpr) and f[i] and \
                f[i][0] in ("export", "import"):
            it = f[i]
            if it[0] == "export":
                exports.append(parse_string(it[1]).decode())
            else:
                imp = (parse_string(it[1]).decode(),
                       parse_string(it[2]).decode())
            i += 1
        return exports, imp, i

    def _field_func(self, f):
        fn = _Func()
        i = 1
        name = None
        if i < len(f) and isinstance(f[i], str) and f[i].startswith("$"):
            name = f[i]
            i += 1
        exports, imp, i = self._inline_export_import(f, i)
        ti, params, results, pnames, rest = self._split_typeuse(f[i:])
        fn.type_idx = ti
        fn.params = params
        fn.results = results
        fn.names = dict(pnames)
        fn.export = exports
        fn.import_mod = imp
        body = []
        for it in rest:
            if isinstance(it, SExpr) and it and it[0] == "local":
                if len(it) == 3 and it[1].startswith("$"):
                    fn.names[it[1]] = len(params) + len(fn.locals)
                    fn.locals.append(it[2])
                else:
                    fn.locals.extend(it[1:])
            else:
                body.append(it)
        fn.body = body
        if imp is not None:
            self.n_imported_funcs += 1
            if any(f2.import_mod is None for f2 in self.funcs):
                raise WatError("imports must precede defined funcs")
        idx = len(self.funcs)
        if name:
            self.func_names[name] = idx
        self.funcs.append(fn)
        for e in exports:
            self.exports.append(("func", e, idx))

    def _field_import(self, f):
        # (import "m" "n" (func $f (type ...)|sig)) / (global ...) /
        # (memory ...) / (table ...)
        mod = parse_string(f[1]).decode()
        nm = parse_string(f[2]).decode()
        desc = f[3]
        kind = desc[0]
        i = 1
        name = None
        if i < len(desc) and isinstance(desc[i], str) and \
                desc[i].startswith("$"):
            name = desc[i]
            i += 1
        if kind == "func":
            ti, params, results, _, _ = self._split_typeuse(desc[i:])
            fn = _Func()
            fn.type_idx = ti
            fn.params = params
            fn.results = results
            fn.import_mod = (mod, nm)
            idx = len(self.funcs)
            if name:
                self.func_names[name] = idx
            self.funcs.append(fn)
            self.n_imported_funcs += 1
        elif kind == "global":
            gt = desc[i]
            mutable = isinstance(gt, SExpr) and gt and gt[0] == "mut"
            vt = gt[1] if mutable else gt
            self.b.import_global(mod, nm, vt, mutable=mutable)
            if name:
                self.global_names[name] = self.n_globals
            self.n_globals += 1
            self.n_imported_globals += 1
        elif kind == "memory":
            mn = int(desc[i])
            mx = int(desc[i + 1]) if i + 1 < len(desc) else None
            self.b.import_memory(mod, nm, mn, mx)
            if name:
                self.mem_names[name] = self.n_mems
            self.n_mems += 1
        elif kind == "table":
            mn = int(desc[i])
            have_max = i + 2 < len(desc)
            mx = int(desc[i + 1]) if have_max else None
            rt = desc[-1]
            self.b.import_table(mod, nm, rt, mn, mx)
            if name:
                self.table_names[name] = self.n_tables
            self.n_tables += 1
        else:
            raise WatError(f"bad import kind {kind}")

    def _field_memory(self, f):
        i = 1
        name = None
        if i < len(f) and isinstance(f[i], str) and f[i].startswith("$"):
            name = f[i]
            i += 1
        exports, imp, i = self._inline_export_import(f, i)
        if imp:
            mn = int(f[i])
            mx = int(f[i + 1]) if i + 1 < len(f) else None
            self.b.import_memory(imp[0], imp[1], mn, mx)
        elif i < len(f) and isinstance(f[i], SExpr) and f[i][0] == "data":
            # (memory (data "..")) — inline data, size = ceil(len/64k)
            data = b"".join(parse_string(s) for s in f[i][1:])
            pages = (len(data) + 65535) // 65536
            self.b.add_memory(pages, pages)
            self.b.add_active_data(0, [("i32.const", 0)], data)
            self.n_datas += 1
        else:
            mn = int(f[i])
            mx = int(f[i + 1]) if i + 1 < len(f) else None
            self.b.add_memory(mn, mx)
        if name:
            self.mem_names[name] = self.n_mems
        for e in exports:
            self.exports.append(("memory", e, self.n_mems))
        self.n_mems += 1

    def _field_table(self, f):
        i = 1
        name = None
        if i < len(f) and isinstance(f[i], str) and f[i].startswith("$"):
            name = f[i]
            i += 1
        exports, imp, i = self._inline_export_import(f, i)
        if imp:
            mn = int(f[i])
            mx = int(f[i + 1]) if i + 2 < len(f) else None
            self.b.import_table(imp[0], imp[1], f[-1], mn, mx)
        elif isinstance(f[-1], SExpr):
            # (table reftype (elem $f1 $f2 ...))
            rt = f[i]
            elems = f[-1][1:]
            n = len(elems)
            self.b.add_table(rt, n, n)
            self._pending_inline_elem = (self.n_tables, elems)
        else:
            mn = int(f[i])
            # a second bare integer before the reftype is the max
            mx = (int(f[i + 1])
                  if i + 1 < len(f) and isinstance(f[i + 1], str)
                  and f[i + 1].lstrip("-").isdigit() else None)
            rt = f[-1]
            self.b.add_table(rt, mn, mx)
        if name:
            self.table_names[name] = self.n_tables
        for e in exports:
            self.exports.append(("table", e, self.n_tables))
        self.n_tables += 1

    _pending_inline_elem = None

    def _field_global(self, f):
        i = 1
        name = None
        if i < len(f) and isinstance(f[i], str) and f[i].startswith("$"):
            name = f[i]
            i += 1
        exports, imp, i = self._inline_export_import(f, i)
        gt = f[i]
        mutable = isinstance(gt, SExpr) and gt and gt[0] == "mut"
        vt = gt[1] if mutable else gt
        if imp:
            self.b.import_global(imp[0], imp[1], vt, mutable=mutable)
            self.n_imported_globals += 1
        else:
            init = self._compile_expr(f[i + 1:], _Func())
            self._pending_globals = getattr(self, "_pending_globals", [])
            self._pending_globals.append((vt, mutable, init, exports))
        if name:
            self.global_names[name] = self.n_globals
        for e in exports:
            self.exports.append(("global", e, self.n_globals))
        self.n_globals += 1

    def _field_export(self, f):
        nm = parse_string(f[1]).decode()
        desc = f[2]
        kind = desc[0]
        spaces = {"func": self.func_names, "global": self.global_names,
                  "table": self.table_names, "memory": self.mem_names}
        idx = self._resolve(desc[1], spaces[kind])
        self.exports.append((kind, nm, idx))

    def _field_start(self, f):
        self.start_idx = self._resolve(f[1], self.func_names)

    def _field_elem(self, f):
        # (elem (i32.const 0) func? $f...) | (elem func $f...) passive
        i = 1
        name = None
        if i < len(f) and isinstance(f[i], str) and f[i].startswith("$"):
            name = f[i]
            i += 1
        if name:
            self.elem_names[name] = self.n_elems
        table_idx = 0
        offset = None
        items = []
        rest = f[i:]
        j = 0
        while j < len(rest):
            it = rest[j]
            if isinstance(it, SExpr) and it and it[0] == "table":
                table_idx = self._resolve(it[1], self.table_names)
            elif isinstance(it, SExpr) and it and it[0] in (
                    "i32.const", "global.get", "offset"):
                expr = it[1:] if it[0] == "offset" else [it]
                offset = self._compile_expr(expr, _Func())
            elif it in ("func", "funcref"):
                pass
            elif isinstance(it, SExpr) and it and it[0] == "ref.func":
                items.append(self._resolve(it[1], self.func_names))
            elif isinstance(it, SExpr) and it and it[0] == "item":
                sub = it[1]
                items.append(self._resolve(sub[1], self.func_names))
            else:
                items.append(self._resolve(it, self.func_names))
            j += 1
        if offset is not None:
            self.b.add_active_elem(table_idx, offset, items)
        else:
            self.b.add_passive_elem(items)
        self.n_elems += 1

    def _field_data(self, f):
        i = 1
        name = None
        if i < len(f) and isinstance(f[i], str) and f[i].startswith("$"):
            name = f[i]
            i += 1
        if name:
            self.data_names[name] = self.n_datas
        mem_idx = 0
        offset = None
        chunks = []
        for it in f[i:]:
            if isinstance(it, SExpr) and it and it[0] == "memory":
                mem_idx = self._resolve(it[1], self.mem_names)
            elif isinstance(it, SExpr) and it and it[0] in (
                    "i32.const", "global.get", "offset"):
                expr = it[1:] if it[0] == "offset" else [it]
                offset = self._compile_expr(expr, _Func())
            else:
                chunks.append(parse_string(it))
        data = b"".join(chunks)
        if offset is not None:
            self.b.add_active_data(mem_idx, offset, data)
        else:
            self.b.add_passive_data(data)
        self.n_datas += 1

    # -- instruction compilation ---------------------------------------
    def _compile_expr(self, items, fn: _Func) -> List:
        out: List = []
        self._seq(items, fn, [], out)
        return out

    def _seq(self, items, fn, labels, out):
        i = 0
        while i < len(items):
            i = self._instr(items, i, fn, labels, out)

    def _v128_const(self, items, i):
        """`v128.const <shape> <lane>...` -> (128-bit int, next index)."""
        shape = items[i]
        if shape not in _V128_SHAPES:
            raise WatError(f"v128.const: bad shape {shape!r}")
        n, w = _V128_SHAPES[shape]
        i += 1
        v = 0
        for k in range(n):
            if shape == "f32x4":
                lane = parse_f32(items[i + k])
            elif shape == "f64x2":
                lane = parse_f64(items[i + k])
            else:
                lane = parse_int(items[i + k], w)
            v |= (lane & ((1 << w) - 1)) << (w * k)
        return v, i + n

    def _label_depth(self, tok, labels) -> int:
        if isinstance(tok, str) and tok.startswith("$"):
            for d, l in enumerate(reversed(labels)):
                if l == tok:
                    return d
            raise WatError(f"unknown label {tok}")
        return int(tok)

    def _blocktype(self, items, i):
        """Parse optional (result t)/(type $t) after block/loop/if."""
        bt = None
        while i < len(items) and isinstance(items[i], SExpr) and \
                items[i] and items[i][0] in ("result", "param", "type"):
            it = items[i]
            if it[0] == "result":
                if len(it) == 2:
                    bt = it[1]
                else:
                    bt = self._intern_type((), tuple(it[1:]))
            elif it[0] == "type":
                bt = self._resolve(it[1], self.type_names)
            else:
                raise WatError("block params unsupported")
            i += 1
        return bt, i

    def _instr(self, items, i, fn, labels, out) -> int:
        it = items[i]
        if isinstance(it, SExpr):
            self._folded(it, fn, labels, out)
            return i + 1
        op = it
        # unfolded block/loop/if ... end
        if op in ("block", "loop", "if"):
            label = None
            j = i + 1
            if j < len(items) and isinstance(items[j], str) and \
                    items[j].startswith("$"):
                label = items[j]
                j += 1
            bt, j = self._blocktype(items, j)
            # find matching end/else at same depth
            body = []
            depth = 0
            else_at = None
            while j < len(items):
                t = items[j]
                if t in ("block", "loop", "if") and not isinstance(t, SExpr):
                    depth += 1
                elif t == "else" and depth == 0 and else_at is None:
                    else_at = len(body)
                    j += 1
                    body.append("else")
                    continue
                elif t == "end":
                    if depth == 0:
                        break
                    depth -= 1
                body.append(t)
                j += 1
            if j >= len(items):
                raise WatError(f"missing end for {op}")
            out.append((op, bt))
            inner = labels + [label]
            # re-run the sequence compiler on the body, translating else
            k = 0
            sub = []
            while k < len(body):
                if body[k] == "else":
                    self._seq_flush(sub, fn, inner, out)
                    sub = []
                    out.append("else")
                    k += 1
                    continue
                sub.append(body[k])
                k += 1
            self._seq_flush(sub, fn, inner, out)
            out.append("end")
            return j + 1
        if op in ("end", "else"):
            raise WatError(f"unexpected {op}")
        return self._plain(items, i, fn, labels, out)

    def _seq_flush(self, toks, fn, labels, out):
        self._seq(toks, fn, labels, out)

    def _plain(self, items, i, fn, labels, out) -> int:
        """One non-block instruction + its immediates from a token list."""
        op = items[i]
        i += 1
        if op in ("unreachable", "nop", "return", "drop",
                  "memory.size", "memory.grow", "memory.copy",
                  "memory.fill", "ref.is_null"):
            out.append((op,))
            return i
        if op == "select":
            if i < len(items) and isinstance(items[i], SExpr) and \
                    items[i] and items[i][0] == "result":
                # typed select (reference-types proposal)
                out.append(("select_t", list(items[i][1:])))
                return i + 1
            out.append((op,))
            return i
        if op == "i32.const":
            out.append((op, parse_int(items[i], 32)))
            return i + 1
        if op == "i64.const":
            out.append((op, parse_int(items[i], 64)))
            return i + 1
        if op == "f32.const":
            out.append((op, parse_f32(items[i])))
            return i + 1
        if op == "f64.const":
            out.append((op, parse_f64(items[i])))
            return i + 1
        if op == "ref.null":
            ht = {"func": "funcref", "extern": "externref"}.get(
                items[i], items[i])
            out.append((op, ht))
            return i + 1
        if op == "v128.const":
            v, i = self._v128_const(items, i)
            out.append((op, v))
            return i
        if op == "i8x16.shuffle":
            lanes = [parse_int(items[i + k], 32) & 0xFF for k in range(16)]
            out.append((op, lanes))
            return i + 16
        if op in _LANE_IMM:
            out.append((op, parse_int(items[i], 32)))
            return i + 1
        if op in _IDX_IMM:
            space = _IDX_IMM[op]
            if space == "table" and (
                    i >= len(items) or not isinstance(items[i], str)
                    or not (items[i].startswith("$")
                            or items[i].isdigit())):
                # the table index is optional in the text format
                # (defaults to table 0): (table.get) == (table.get 0)
                out.append((op, 0))
                return i
            tok = items[i]
            if space == "label":
                out.append((op, self._label_depth(tok, labels)))
            elif space == "local":
                out.append((op, self._resolve(tok, fn.names)))
            elif space == "func":
                out.append((op, self._resolve(tok, self.func_names)))
            elif space == "global":
                out.append((op, self._resolve(tok, self.global_names)))
            elif space == "table":
                out.append((op, self._resolve(tok, self.table_names)))
            elif space == "elem":
                out.append((op, self._resolve(tok, self.elem_names)))
            elif space == "data":
                out.append((op, self._resolve(tok, self.data_names)))
            return i + 1
        if op == "br_table":
            lbls = []
            while i < len(items) and (
                    (isinstance(items[i], str) and
                     (items[i].startswith("$") or items[i].isdigit()))):
                lbls.append(self._label_depth(items[i], labels))
                i += 1
            out.append((op, lbls[:-1], lbls[-1]))
            return i
        if op in ("call_indirect", "return_call_indirect"):
            tbl = 0
            if i < len(items) and isinstance(items[i], str) and \
                    (items[i].startswith("$") or items[i].isdigit()):
                tbl = self._resolve(items[i], self.table_names)
                i += 1
            tu = []
            while i < len(items) and isinstance(items[i], SExpr) and \
                    items[i] and items[i][0] in ("type", "param", "result"):
                tu.append(items[i])
                i += 1
            ti, _, _, _, _rest = self._split_typeuse(tu)
            out.append((op, ti, tbl))
            return i
        if op == "table.copy":
            # (table.copy $dst $src) | bare = table 0 -> table 0
            dst = src = 0
            toks = []
            while i < len(items) and isinstance(items[i], str) and \
                    (items[i].startswith("$") or items[i].isdigit()):
                toks.append(items[i])
                i += 1
            if len(toks) == 2:
                dst = self._resolve(toks[0], self.table_names)
                src = self._resolve(toks[1], self.table_names)
            elif toks:
                raise WatError("table.copy expects 0 or 2 table indices")
            out.append((op, dst, src))
            return i
        if op == "table.init":
            # (table.init $t $e) | (table.init $e)
            tbl, seg = 0, None
            toks = []
            while i < len(items) and isinstance(items[i], str) and \
                    (items[i].startswith("$") or items[i].isdigit()):
                toks.append(items[i])
                i += 1
            if len(toks) == 1:
                seg = self._resolve(toks[0], self.elem_names)
            elif len(toks) >= 2:
                tbl = self._resolve(toks[0], self.table_names)
                seg = self._resolve(toks[1], self.elem_names)
            else:
                raise WatError("table.init: missing element segment")
            out.append((op, seg, tbl))
            return i
        if op in _MEM_OPS:
            align = _MEM_OPS[op]
            offset = 0
            while i < len(items) and isinstance(items[i], str) and \
                    ("=" in items[i]):
                k, v = items[i].split("=")
                if k == "offset":
                    offset = int(v.replace("_", ""), 0)
                elif k == "align":
                    a = int(v.replace("_", ""), 0)
                    align = a.bit_length() - 1
                i += 1
            out.append((op, align, offset))
            return i
        # no-immediate numeric/etc op
        out.append((op,))
        return i

    def _folded(self, e: SExpr, fn, labels, out):
        op = e[0]
        if op in ("block", "loop"):
            i = 1
            label = None
            if i < len(e) and isinstance(e[i], str) and e[i].startswith("$"):
                label = e[i]
                i += 1
            bt, i = self._blocktype(e, i)
            out.append((op, bt))
            self._seq(e[i:], fn, labels + [label], out)
            out.append("end")
            return
        if op == "if":
            i = 1
            label = None
            if i < len(e) and isinstance(e[i], str) and e[i].startswith("$"):
                label = e[i]
                i += 1
            bt, i = self._blocktype(e, i)
            # condition exprs come before (then ...)
            then_i = None
            for j in range(i, len(e)):
                if isinstance(e[j], SExpr) and e[j] and e[j][0] == "then":
                    then_i = j
                    break
            if then_i is None:
                raise WatError("if: missing (then ...)")
            for cond in e[i:then_i]:
                self._folded(cond, fn, labels, out)
            out.append(("if", bt))
            inner = labels + [label]
            self._seq(e[then_i][1:], fn, inner, out)
            if then_i + 1 < len(e):
                els = e[then_i + 1]
                if not (isinstance(els, SExpr) and els and els[0] == "else"):
                    raise WatError("if: expected (else ...)")
                out.append("else")
                self._seq(els[1:], fn, inner, out)
            out.append("end")
            return
        # general folded: operands first, then the op with immediates
        toks = []
        exprs = []
        for x in e[1:]:
            if isinstance(x, SExpr) and x and x[0] not in (
                    "type", "param", "result"):
                exprs.append(x)
            else:
                toks.append(x)
        for sub in exprs:
            self._folded(sub, fn, labels, out)
        self._plain([op] + toks, 0, fn, labels, out)

    # -- emission --------------------------------------------------------
    def _emit(self):
        # replay interned types in order; ModuleBuilder dedups by key, so
        # duplicate (type) forms would skew indices — reject them
        for want, (params, results) in enumerate(self.types):
            got = self.b.add_type(list(params), list(results))
            if got != want:
                raise WatError("duplicate (type) forms unsupported")
        self._types_emitted = len(self.types)
        for fn in self.funcs:
            if fn.import_mod is not None:
                tp, tr = self.types[fn.type_idx]
                self.b.import_func(fn.import_mod[0], fn.import_mod[1],
                                   list(tp), list(tr))
        for gdef in getattr(self, "_pending_globals", []):
            vt, mutable, init, _exp = gdef
            self.b.add_global(vt, mutable, init)
        if self._pending_inline_elem is not None:
            tbl, elems = self._pending_inline_elem
            idxs = [self._resolve(t, self.func_names) for t in elems]
            self.b.add_active_elem(tbl, [("i32.const", 0)], idxs)
        for fn in self.funcs:
            if fn.import_mod is not None:
                continue
            body = []
            self._seq(fn.body, fn, [None], body)
            tp, tr = self.types[fn.type_idx]
            self.b.add_function(list(tp), list(tr), fn.locals, body)
        # call_indirect typeuses interned during body compilation above
        # extend self.types; replay the tail into the builder
        for want in range(self._types_emitted, len(self.types)):
            params, results = self.types[want]
            got = self.b.add_type(list(params), list(results))
            if got != want:
                raise WatError("late type interning index skew")
        for kind, nm, idx in self.exports:
            enc = {"func": 0, "table": 1, "memory": 2, "global": 3}[kind]
            self.b.exports.append(self.b._name(nm) + bytes([enc]) + uleb(idx))
        if self.start_idx is not None:
            self.b.set_start(self.start_idx)
        if self.b.datas:
            # memory.init/data.drop validation needs the DataCount
            # section; emitting it whenever data segments exist is legal
            self.b.data_count = len(self.b.datas)

    def build(self) -> bytes:
        return self.b.build()


def parse_wat(src: str) -> bytes:
    """Compile a single (module ...) text form (or bare fields) to binary."""
    exprs = parse_sexprs(tokenize(src))
    if len(exprs) == 1 and isinstance(exprs[0], SExpr) and \
            exprs[0] and exprs[0][0] == "module":
        fields = exprs[0][1:]
        if fields and isinstance(fields[0], str) and \
                fields[0].startswith("$"):
            fields = fields[1:]
    else:
        fields = exprs
    return compile_module_fields(SExpr(fields))


def compile_module_fields(fields: SExpr) -> bytes:
    return WatCompiler(fields).build()


# ---------------------------------------------------------------------------
# wast scripts
# ---------------------------------------------------------------------------


class WastCommand:
    """One spec-script command (SpecTest command model)."""

    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.__dict__.update(kw)

    def __repr__(self):
        return f"<wast {self.kind} {self.__dict__}>"


def _parse_action(e: SExpr):
    # (invoke $mod? "name" const*) | (get $mod? "name")
    kind = e[0]
    i = 1
    mod = None
    if i < len(e) and isinstance(e[i], str) and e[i].startswith("$"):
        mod = e[i]
        i += 1
    name = parse_string(e[i]).decode()
    args = [_parse_const(c) for c in e[i + 1:]]
    return kind, mod, name, args


def _parse_const(e: SExpr):
    """(t.const lit) -> (type, bits-or-special)."""
    op = e[0]
    t = op.split(".")[0]
    if op == "i32.const":
        return ("i32", parse_int(e[1], 32))
    if op == "i64.const":
        return ("i64", parse_int(e[1], 64))
    if op == "f32.const":
        if e[1] in ("nan:canonical", "nan:arithmetic"):
            return ("f32", e[1])
        return ("f32", parse_f32(e[1]))
    if op == "f64.const":
        if e[1] in ("nan:canonical", "nan:arithmetic"):
            return ("f64", e[1])
        return ("f64", parse_f64(e[1]))
    if op == "ref.null":
        return ("ref", 0)
    if op == "ref.extern":
        return ("ref", int(e[1]))
    if op == "v128.const":
        shape = e[1]
        if shape not in _V128_SHAPES:
            raise WatError(f"v128.const: bad shape {shape!r}")
        n, w = _V128_SHAPES[shape]
        lanes = list(e[2:2 + n])
        if shape in ("f32x4", "f64x2") and any(
                ln in ("nan:canonical", "nan:arithmetic") for ln in lanes):
            # per-lane expected list for float shapes with NaN classes
            vals = []
            for ln in lanes:
                if ln in ("nan:canonical", "nan:arithmetic"):
                    vals.append(ln)
                elif shape == "f32x4":
                    vals.append(parse_f32(ln))
                else:
                    vals.append(parse_f64(ln))
            return ("v128", (shape, vals))
        v = 0
        for k in range(n):
            if shape == "f32x4":
                lane = parse_f32(lanes[k])
            elif shape == "f64x2":
                lane = parse_f64(lanes[k])
            else:
                lane = parse_int(lanes[k], w)
            v |= (lane & ((1 << w) - 1)) << (w * k)
        return ("v128", v)
    raise WatError(f"bad const {op}")


def parse_wast(src: str) -> List[WastCommand]:
    cmds = []
    for e in parse_sexprs(tokenize(src)):
        if not isinstance(e, SExpr) or not e:
            raise WatError(f"bad wast form {e}")
        kind = e[0]
        if kind == "module":
            name = None
            i = 1
            if i < len(e) and isinstance(e[i], str) and e[i].startswith("$"):
                name = e[i]
                i += 1
            if i < len(e) and e[i] == "binary":
                data = b"".join(parse_string(s) for s in e[i + 1:])
                cmds.append(WastCommand("module_binary", name=name,
                                        data=data))
            elif i < len(e) and e[i] == "quote":
                text = b"".join(parse_string(s) for s in e[i + 1:]).decode()
                cmds.append(WastCommand("module_quote", name=name,
                                        text=text))
            else:
                cmds.append(WastCommand("module", name=name,
                                        fields=SExpr(e[i:])))
        elif kind == "register":
            nm = parse_string(e[1]).decode()
            mod = e[2] if len(e) > 2 else None
            cmds.append(WastCommand("register", as_name=nm, mod=mod))
        elif kind in ("invoke", "get"):
            akind, mod, name, args = _parse_action(e)
            cmds.append(WastCommand("action", action=(akind, mod, name,
                                                      args)))
        elif kind == "assert_return":
            akind, mod, name, args = _parse_action(e[1])
            expected = [_parse_const(r) for r in e[2:]]
            cmds.append(WastCommand("assert_return",
                                    action=(akind, mod, name, args),
                                    expected=expected))
        elif kind in ("assert_trap", "assert_exhaustion"):
            akind, mod, name, args = _parse_action(e[1])
            msg = parse_string(e[2]).decode() if len(e) > 2 else ""
            cmds.append(WastCommand(kind, action=(akind, mod, name, args),
                                    message=msg))
        elif kind in ("assert_invalid", "assert_malformed",
                      "assert_unlinkable"):
            sub = e[1]
            msg = parse_string(e[2]).decode() if len(e) > 2 else ""
            i = 1
            if i < len(sub) and isinstance(sub[i], str) and \
                    sub[i].startswith("$"):
                i += 1
            if i < len(sub) and sub[i] == "binary":
                data = b"".join(parse_string(s) for s in sub[i + 1:])
                cmds.append(WastCommand(kind, form="binary", data=data,
                                        message=msg))
            elif i < len(sub) and sub[i] == "quote":
                text = b"".join(parse_string(s)
                                for s in sub[i + 1:]).decode()
                cmds.append(WastCommand(kind, form="quote", text=text,
                                        message=msg))
            else:
                cmds.append(WastCommand(kind, form="text",
                                        fields=SExpr(sub[i:]), message=msg))
        else:
            raise WatError(f"unsupported wast command {kind}")
    return cmds
