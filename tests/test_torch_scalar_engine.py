"""The port's scalar engine against the JAX package's, bit for bit.

- every handler of `executor/numeric.py`'s HANDLERS (the v128 ones that
  `executor/simd.py` registers included), the port's against the JAX
  package's, on operands made from a seeded generator plus edge values
  (NaNs of both signs and payloads, signed zeros, subnormals, infinities,
  INT_MIN, -1, the float bounds of the truncations): the same stack or
  the same trap code;
- the v128 lane helpers (`shuffle`, `extract_lane`, `replace_lane`,
  `pack`) on random vectors;
- the modules of the JAX package's `tests/test_executor.py` (control
  flow, call_indirect and its traps, globals, memory, bulk memory, host
  functions, a registered module, a start function), built once with the
  port's `ModuleBuilder` and run through both `Executor`s: the same
  results or trap codes;
- `Statistics`: instruction counts and costs (flat and weighted) equal
  on both sides, the cost-limit trap at the same total, and the timers.
"""

import numpy as np
import pytest

from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import WasmError as RefWasmError
from wasmedge_tpu.common.statistics import Statistics as RefStatistics
from wasmedge_tpu.executor import Executor as RefExecutor
from wasmedge_tpu.executor import simd as ref_simd
from wasmedge_tpu.executor.numeric import HANDLERS as REF_HANDLERS
from wasmedge_tpu.loader import Loader as RefLoader
from wasmedge_tpu.runtime.hostfunc import ImportObject as RefImportObject
from wasmedge_tpu.runtime.store import StoreManager as RefStore
from wasmedge_tpu.validator import Validator as RefValidator
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import ErrCode, TrapError, WasmError
from wasmedge_tpu_torch.common.opcodes import NAME_TO_ID, OPCODES
from wasmedge_tpu_torch.common.statistics import Statistics
from wasmedge_tpu_torch.executor import Executor
from wasmedge_tpu_torch.executor import simd
from wasmedge_tpu_torch.executor.numeric import HANDLERS
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models import build_fac, build_fib, build_loop_sum
from wasmedge_tpu_torch.runtime.hostfunc import ImportObject
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.utils.builder import ModuleBuilder
from wasmedge_tpu_torch.validator import Validator

SEED = 20261018
M32, M64 = (1 << 32) - 1, (1 << 64) - 1

EDGE = {
    "i": [0, 1, 2, M32, 0x80000000, 0x7FFFFFFF, 31, 32, 33, 0xFFFFFFFE],
    "I": [0, 1, 2, M64, 1 << 63, (1 << 63) - 1, 63, 64, 65, 0xFFFFFFFF,
          1 << 32],
    "f": [0x00000000, 0x80000000, 0x00000001, 0x007FFFFF, 0x80000001,
          0x00800000, 0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FA00000,
          0xFFA00001, 0x7F800000, 0xFF800000, 0x3F800000, 0xBF800000,
          0x3F000000, 0x3FC00000, 0x7F7FFFFF, 0x4F000000, 0xCF000000,
          0x4F800000, 0xCF000001, 0x5F000000, 0xDF000000, 0x4EFFFFFF],
    "F": [0, 1 << 63, 1, 0x000FFFFFFFFFFFFF, (1 << 63) | 1,
          0x7FF8000000000000, 0xFFF8000000000000, 0x7FF0000000000001,
          0x7FF4000000000000, 0x7FF0000000000000, 0xFFF0000000000000,
          0x3FF0000000000000, 0xBFF0000000000000, 0x3FE0000000000000,
          0x3FF8000000000000, 0x7FEFFFFFFFFFFFFF, 0x41E0000000000000,
          0xC1E0000000000000, 0x41EFFFFFFFE00000, 0x41F0000000000000,
          0x43E0000000000000, 0xC3E0000000000000, 0xC1E0000000200000],
}


def _v128_edges():
    """v128 words whose lanes hold the i8 / i16 / f32 / f64 edges."""
    out = [0, (1 << 128) - 1]
    for w, vals in ((32, EDGE["f"]), (64, EDGE["F"])):
        n = 128 // w
        for i in range(0, len(vals), n):
            chunk = (vals[i:i + n] * n)[:n]
            out.append(sum(v << (w * k) for k, v in enumerate(chunk)))
    for b in (0x00, 0x01, 0x7F, 0x80, 0xFF, 0x8000, 0x7FFF):
        width = 8 if b <= 0xFF else 16
        out.append(sum(b << (width * k) for k in range(128 // width)))
    return out


EDGE["V"] = _v128_edges()
BITS = {"i": 32, "I": 64, "f": 32, "F": 64, "V": 128}


def _operands(sig: str, rng, n_random: int = 48):
    """Stacks for an op with input types `sig`: every edge value of each
    operand against seeded random partners, then random bit patterns."""
    kinds = list(sig)

    def rnd(c):
        return int.from_bytes(rng.bytes(BITS[c] // 8), "little")

    stacks = []
    for pos, c in enumerate(kinds):
        for v in EDGE[c]:
            for partner in range(2):
                st = [rnd(k) if partner else EDGE[k][(j + len(stacks)) % len(EDGE[k])]
                      for j, k in enumerate(kinds)]
                st[pos] = v
                stacks.append(st)
    stacks += [[rnd(c) for c in kinds] for _ in range(n_random)]
    return stacks


def _apply(handlers, op, st):
    st = list(st)
    try:
        handlers[op](st)
    except (TrapError, RefWasmError) as e:
        return ("trap", int(e.code))
    return ("ok", st)


HANDLER_OPS = sorted(REF_HANDLERS, key=lambda o: OPCODES[o].name)


def test_the_handler_tables_cover_the_same_ops():
    assert set(HANDLERS) == set(REF_HANDLERS)
    assert len(HANDLERS) > 300  # the numeric and v128 handlers


@pytest.mark.parametrize("op", HANDLER_OPS, ids=lambda o: OPCODES[o].name)
def test_handler_matches_jax(op):
    info = OPCODES[op]
    pops = info.sig.split("->")[0]
    rng = np.random.default_rng(SEED + op)
    for st in _operands(pops, rng):
        got, want = _apply(HANDLERS, op, st), _apply(REF_HANDLERS, op, st)
        assert got == want, (info.name, [hex(v) for v in st], got, want)


def test_v128_lane_helpers_match_jax():
    rng = np.random.default_rng(SEED)
    shapes = {"i8x16": 16, "i16x8": 8, "i32x4": 4, "i64x2": 2, "f32x4": 4,
              "f64x2": 2}
    for _ in range(300):
        a, b, m, x = (int.from_bytes(rng.bytes(16), "little")
                      for _ in range(4))
        mask = int.from_bytes(bytes(rng.integers(0, 32, 16, np.uint8)),
                              "little")
        assert simd.shuffle(a, b, mask) == ref_simd.shuffle(a, b, mask)
        for shape, n in shapes.items():
            lane = int(rng.integers(0, n))
            for signed in (False, True):
                assert simd.extract_lane(a, shape, lane, signed) == \
                    ref_simd.extract_lane(a, shape, lane, signed)
            assert simd.replace_lane(a, shape, lane, x & M64) == \
                ref_simd.replace_lane(a, shape, lane, x & M64)
        for w in (8, 16, 32, 64):
            vals = [int(v) for v in rng.integers(-(1 << (w - 1)),
                                                 1 << (w - 1), 128 // w)]
            assert simd.pack(vals, w) == ref_simd.pack(vals, w)
        del m


# ---------------------------------------------------------------------------
# the modules of tests/test_executor.py through both executors
# ---------------------------------------------------------------------------
def _single(params, results, locals_, body):
    b = ModuleBuilder()
    b.add_function(params, results, locals_, body, export="f")
    return b.build()


def _call_indirect_mod():
    b = ModuleBuilder()
    add = b.add_function(["i32", "i32"], ["i32"], [],
                         [("local.get", 0), ("local.get", 1), "i32.add"])
    sub = b.add_function(["i32", "i32"], ["i32"], [],
                         [("local.get", 0), ("local.get", 1), "i32.sub"])
    other = b.add_function([], [], [], [])
    b.add_table("funcref", 4)
    b.add_active_elem(0, [("i32.const", 0)], [add, sub, other])
    ti = b.add_type(["i32", "i32"], ["i32"])
    b.add_function(["i32", "i32", "i32"], ["i32"], [], [
        ("local.get", 1), ("local.get", 2),
        ("local.get", 0), ("call_indirect", ti, 0),
    ], export="f")
    return b.build()


def _mem(body, results, params=(), max_pages=None):
    b = ModuleBuilder()
    b.add_memory(1, max_pages)
    b.add_function(list(params), results, [], body, export="f")
    return b


def _loop_with_params():
    b = ModuleBuilder()
    ti = b.add_type(["i32"], ["i32"])
    b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("loop", ti), ("local.set", 0),
        ("local.get", 0), ("i32.const", 0), "i32.gt_s", ("if", None),
        ("local.get", 0), ("i32.const", 1), "i32.sub", ("br", 1), "end",
        ("local.get", 0), "end"], export="f")
    return b.build()


def _global_mod():
    b = ModuleBuilder()
    b.add_global("i32", True, [("i32.const", 10)])
    b.add_function([], ["i32"], [], [
        ("global.get", 0), ("i32.const", 5), "i32.add", ("global.set", 0),
        ("global.get", 0)], export="f")
    return b.build()


def _start_mod():
    b = ModuleBuilder()
    b.add_global("i32", True, [("i32.const", 0)])
    s = b.add_function([], [], [], [("i32.const", 99), ("global.set", 0)])
    b.set_start(s)
    b.add_function([], ["i32"], [], [("global.get", 0)], export="f")
    return b.build()


def _data_mod():
    b = _mem([("i32.const", 4), ("i32.load", 2, 0)], ["i32"])
    b.add_active_data(0, [("i32.const", 4)], b"\x2a\x00\x00\x00")
    return b.build()


def _passive_mod():
    b = _mem([("i32.const", 20), ("i32.const", 1), ("i32.const", 2),
              ("memory.init", 0), ("i32.const", 20), ("i32.load16_u", 0, 0)],
             ["i32"])
    b.data_count = 1
    b.add_passive_data(b"\x01\x02\x03\x04")
    return b.build()


def _host_mod():
    b = ModuleBuilder()
    f = b.import_func("env", "double", ["i32"], ["i32"])
    peek = b.import_func("env", "peek", ["i32"], ["i32"])
    b.add_memory(1)
    b.add_function(["i32"], ["i32"], [], [
        ("i32.const", 12), ("local.get", 0), ("i32.store", 2, 0),
        ("local.get", 0), ("call", f), ("i32.const", 12), ("call", peek),
        "i32.add"], export="f")
    return b.build()


def _host(cls):
    imp = cls("env")
    imp.add_py_func("double", lambda mem, x: x * 2, ["i32"], ["i32"])
    imp.add_py_func("peek", lambda mem, a: mem.load(a, 4, False), ["i32"],
                    ["i32"])
    return imp


# name -> (module bytes, export, [args], host module)
MODULES = {
    "fib": (build_fib(), "fib", [[0], [1], [10], [20]], False),
    "fac": (build_fac(), "fac", [[12], [20]], False),
    "loop_sum": (build_loop_sum(), "loop_sum", [[100], [0]], False),
    "block_br": (_single([], ["i32"], [], [
        ("block", "i32"), ("block", None), ("i32.const", 7), ("br", 1),
        "end", ("i32.const", 99), "end"]), "f", [[]], False),
    "loop_params": (_loop_with_params(), "f", [[5], [0]], False),
    "br_table": (_single(["i32"], ["i32"], [], [
        ("block", None), ("block", None), ("block", None),
        ("local.get", 0), ("br_table", [0, 1], 2),
        "end", ("i32.const", 10), "return",
        "end", ("i32.const", 20), "return",
        "end", ("i32.const", 30)]), "f", [[0], [1], [2], [100], [-1]],
        False),
    "select": (_single(["i32"], ["i32"], [], [
        ("i32.const", 111), ("i32.const", 222), ("local.get", 0),
        "select"]), "f", [[1], [0]], False),
    "unreachable": (_single([], [], [], ["unreachable"]), "f", [[]], False),
    "multivalue": (_single(["i32"], ["i32", "i32"], [], [
        ("local.get", 0), ("i32.const", 1), "i32.add",
        ("local.get", 0), ("i32.const", 2), "i32.add"]), "f", [[10]],
        False),
    "call_stack": (_single([], [], [], [("call", 0)]), "f", [[]], False),
    "call_indirect": (_call_indirect_mod(), "f",
                      [[0, 30, 12], [1, 30, 12], [2, 0, 0], [3, 0, 0],
                       [100, 0, 0]], False),
    "globals": (_global_mod(), "f", [[]], False),
    "load_store": (_mem([("local.get", 0), ("local.get", 1),
                         ("i32.store", 2, 0), ("local.get", 0),
                         ("i32.load", 2, 0)], ["i32"], ["i32", "i32"])
                   .build(), "f", [[100, -123], [65532, 7], [65533, 7]],
                   False),
    "subword": (_mem([("i32.const", 8), ("i32.const", 0x80FF),
                      ("i32.store", 2, 0), ("i32.const", 8),
                      ("i32.load8_s", 0, 0), ("i32.const", 8),
                      ("i32.load8_u", 0, 1), ("i32.const", 0),
                      ("i64.load32_u", 2, 8)], ["i32", "i32", "i64"])
                .build(), "f", [[]], False),
    "grow": (_mem(["memory.size", ("i32.const", 1), "memory.grow",
                   ("i32.const", 5), "memory.grow", "memory.size"],
                  ["i32"] * 4, max_pages=3).build(), "f", [[]], False),
    "data": (_data_mod(), "f", [[]], False),
    "bulk": (_mem([("i32.const", 0), ("i32.const", 0xAB), ("i32.const", 8),
                   "memory.fill", ("i32.const", 16), ("i32.const", 0),
                   ("i32.const", 4), "memory.copy", ("i32.const", 16),
                   ("i32.load", 2, 0)], ["i32"]).build(), "f", [[]], False),
    "memory_init": (_passive_mod(), "f", [[]], False),
    "host": (_host_mod(), "f", [[21], [-5]], True),
    "start": (_start_mod(), "f", [[]], False),
}


def _run(side, data, func, args_list, host):
    """(results or trap code) of each call, on one fresh instance per
    module, for the port ("port") or the JAX package ("ref")."""
    if side == "port":
        conf, store = Configure(), StoreManager()
        ex = Executor(conf)
        mod = Validator(conf).validate(Loader(conf).parse_module(data))
        if host:
            ex.register_import_object(store, _host(ImportObject))
        errs = (WasmError,)
    else:
        conf, store = RefConfigure(), RefStore()
        ex = RefExecutor(conf)
        mod = RefValidator(conf).validate(RefLoader(conf).parse_module(data))
        if host:
            ex.register_import_object(store, _host(RefImportObject))
        errs = (RefWasmError,)
    inst = ex.instantiate(store, mod)
    out = []
    for args in args_list:
        try:
            out.append([int(v) for v in ex.invoke(store, inst.find_func(func),
                                                   list(args))])
        except errs as e:
            out.append(("trap", int(e.code)))
    return out


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax_executor(name):
    data, func, args_list, host = MODULES[name]
    got = _run("port", data, func, args_list, host)
    assert got == _run("ref", data, func, args_list, host)
    assert any(not isinstance(r, tuple) for r in got) or name in (
        "unreachable", "call_stack")


def test_traps_of_the_executor_modules():
    """The trap codes the JAX package's tests name, on the port."""
    want = {"unreachable": [("trap", int(ErrCode.Unreachable))],
            "call_stack": [("trap", int(ErrCode.CallStackExhausted))]}
    for name, codes in want.items():
        data, func, args_list, host = MODULES[name]
        assert _run("port", data, func, args_list, host) == codes
    got = _run("port", *MODULES["call_indirect"][:3], False)
    assert got[2:] == [("trap", int(ErrCode.IndirectCallTypeMismatch)),
                       ("trap", int(ErrCode.UninitializedElement)),
                       ("trap", int(ErrCode.UndefinedElement))]
    assert _run("port", *MODULES["load_store"][:3], False)[2] == \
        ("trap", int(ErrCode.MemoryOutOfBounds))


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------
def _stat_run(side, conf_of, func="fib", args=(15,), table=None):
    """Run fib on one side under a Statistics built from `conf_of(conf)`;
    (instr_count, total_cost, result or trap code)."""
    if side == "port":
        conf = Configure()
        conf_of(conf)
        stat = Statistics(conf)
        ex = Executor(conf, stat)
        store = StoreManager()
        mod = Validator(conf).validate(Loader(conf).parse_module(build_fib()))
        errs = (WasmError,)
    else:
        conf = RefConfigure()
        conf_of(conf)
        stat = RefStatistics(conf)
        ex = RefExecutor(conf, stat)
        store = RefStore()
        mod = RefValidator(conf).validate(
            RefLoader(conf).parse_module(build_fib()))
        errs = (RefWasmError,)
    if table is not None:
        stat.cost_table = list(table)
    inst = ex.instantiate(store, mod)
    try:
        out = ex.invoke(store, inst.find_func(func), list(args))
    except errs as e:
        out = ("trap", int(e.code))
    return stat.instr_count, stat.total_cost, out, stat


def _counting(conf):
    conf.statistics.instr_counting = True
    conf.statistics.cost_measuring = True
    conf.statistics.time_measuring = True


def test_statistics_count_like_jax():
    got = _stat_run("port", _counting)
    want = _stat_run("ref", _counting)
    assert got[:3] == want[:3]
    assert got[0] == got[1] > 100 and got[2] == [610]
    stat = got[3]
    assert stat.wasm_ns > 0 and stat.instr_per_second > 0
    d = stat.dump()
    assert {k: d[k] for k in ("instr_count", "total_cost")} == \
        {"instr_count": got[0], "total_cost": got[1]}
    stat.reset()
    assert stat.instr_count == stat.total_cost == stat.wasm_ns == 0


def test_weighted_costs_like_jax():
    table = [1] * len(Statistics().cost_table)
    for name, w in (("i32.add", 3), ("call", 7), ("i32.lt_s", 2)):
        table[NAME_TO_ID[name]] = w
    got = _stat_run("port", _counting, table=table)
    want = _stat_run("ref", _counting, table=table)
    assert got[:3] == want[:3] and got[1] > got[0]
    assert len(table) == len(RefStatistics().cost_table)


@pytest.mark.parametrize("limit", [0, 1, 50, 1000, 5000])
def test_cost_limit_traps_like_jax(limit):
    def conf_of(conf):
        _counting(conf)
        conf.statistics.cost_limit = limit

    got = _stat_run("port", conf_of)
    want = _stat_run("ref", conf_of)
    assert got[:3] == want[:3]
    assert got[2] == ("trap", int(ErrCode.CostLimitExceeded))
    # the trap fires at the first instruction past the limit
    assert got[1] == limit + 1
