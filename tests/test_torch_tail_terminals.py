"""Call, div and chain terminals in B2 instance cases on the port against
the JAX package.

A B2 instance case (`batch/fusegen.py`) runs call_indirect, return_call
and return_call_indirect terminals itself, through the one call body
the per-op step runs (`csrc/interp.cu` `call_op`), and a div or rem
terminal, chained to the lone call after it (a direct call in the case,
any other run by the per-op code in the same turn).  Checks, all
bit-exact:

  - the generated sources of the tail dispatch and of the linked program
    hold those terminals at the expected heads; a chained head's fused
    length, budget and gas test count the call;
  - the B2 planner's shapes are the JAX planner's on these modules;
  - through the port's plain engine on the CPU, the tail dispatch at
    small n per launch against the JAX `BatchEngine.run_from_state`
    (superinstruction fusion and tier-up off), every plane (rows below sp
    where a fused dispatch or a rollback leaves dead rows above), in
    blocks and per op, kOpt and careful, windows and direct, flat fuel
    and weighted gas; its results against `tail_dispatch_model`;
  - launches and fuel that end one op inside a chain, and fuel that runs
    out on the chained call, per launch against the JAX package, per op
    and in blocks;
  - every trap of the new terminals (the table zoo's
    `table_terminal_cases`) per launch against the JAX package.
"""

import numpy as np
import pytest

from wasmedge_tpu.batch import pallas_engine as P
from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.configure import Proposal as RefProposal
from wasmedge_tpu_torch.batch import fusegen, fusion
from wasmedge_tpu_torch.batch.engine import cost_plane
from wasmedge_tpu_torch.batch.interp import (
    H_CALL_INDIRECT, H_RETCALL_INDIRECT, device_tables, hid_plane)
from wasmedge_tpu_torch.common.errors import ErrCode
from wasmedge_tpu_torch.models.fixtures import (
    TABLE_ZOO_CAP, build_linked_program, build_table_zoo,
    build_tail_dispatch, table_terminal_cases, tail_cost_table,
    tail_dispatch_args, tail_dispatch_model)
from wasmedge_tpu_torch.utils.wat import parse_wat
from tests.helpers import instantiate as ref_instantiate
from tests.test_torch_interp import _image_of
from tests.test_torch_tables import (
    _port_conf, port_engine, port_replay, ref_trajectory)

LANES = 40
N = 12
CHUNK = 64
FUEL = 412  # the tail dispatch runs out after about 9 steps
ZOO_KNOBS = {"table_elems_per_lane": TABLE_ZOO_CAP}  # stacks 64 / 16
ZOO_CHUNK = 23  # launches end inside blocks and chains
# a chain at a function's entry: lget, lget, const 3, rem_u, then the
# call_indirect through slot x % 3 (2 is null)
WAT_CHAIN = """(module
  (type $u (func (param i32) (result i32)))
  (table 3 funcref)
  (func $inc (type $u) (i32.add (local.get 0) (i32.const 1)))
  (func $dbl (type $u) (i32.mul (local.get 0) (i32.const 2)))
  (elem (i32.const 0) $inc $dbl)
  (func (export "chain") (param $x i32) (result i32)
    (call_indirect (type $u) (local.get $x)
      (i32.rem_u (local.get $x) (i32.const 3)))))"""
SEED = 20261018


def _ref_image(data):
    conf = RefConfigure()
    conf.add_proposal(RefProposal.TailCall)
    _, store, inst = ref_instantiate(data, conf)
    return RefEngine(inst, store=store, conf=conf, lanes=2).img


def _blocks(data):
    img = _image_of(_ref_image(data))
    return img, device_tables(img, "cpu", "blocks")


def _case_text(src, pc):
    at = src.index("at_pc(")
    start = src.index(f"      case {pc}: {{", at)
    return src[start:src.index("\n      }\n", start)]


def test_tail_dispatch_chains_its_calls():
    """Every handler's last block ends in the rem_u by 9, which its case
    runs, and chains the return_call_indirect after it (the per-op code
    runs it in the same turn); the guard block's return runs in its
    case."""
    img, t = _blocks(build_tail_dispatch())
    src = t.fused_source
    counts = fusegen.terminal_counts(src)
    assert counts["div_rem"] == counts["chained"] == 9  # 8 handlers, run
    assert counts["return"] == 8
    hid0 = t.hid0.numpy()
    chains = fusegen.chains(t.hid.numpy(), hid0, t.shapes)
    assert len(chains) == 9
    calls = np.nonzero(hid0 == H_RETCALL_INDIRECT)[0].tolist()
    assert sorted(chains.values()) == calls
    flen = t.flen.numpy()
    for head, call in chains.items():
        shape = t.shapes[int(t.hid[head]) - fusion.H_BLOCK_BASE]
        assert call == head + len(shape)
        assert flen[head] == len(shape) + 1
        text = _case_text(src, head)
        n = len(shape) + 1
        assert f"if (left < {n} || (p.fuel_on && fuel <= {n}))" in text
        assert f"// chained call at {call}: {H_RETCALL_INDIRECT}" in text
        assert text.endswith(f"pc = {call};\n        n = {n - 1};\n"
                             f"        return {H_RETCALL_INDIRECT};")
        # rem_u by the literal 9 cannot trap: no test, no agreement
        assert "w.agree" not in text


def test_weighted_gas_tests_the_chain_weight():
    """With weighted gas a chained case tests the fuel against the
    literal weight of the block, the rem_u and the call (5)."""
    conf = _port_conf(CHUNK, {}, FUEL, tail_cost_table())
    eng, _ = port_engine(build_tail_dispatch(), 2, conf)
    cost = cost_plane(eng.img, eng.cfg)
    t = device_tables(eng.img, "cpu", "blocks", cost=cost)
    for head, call in fusegen.chains(t.hid.numpy(), t.hid0.numpy(),
                                     t.shapes).items():
        n = int(t.flen[head])
        w = int(cost[head:head + n].sum())
        assert int(cost[call]) == 5 and w == n + 4
        assert f"fuel <= {w}))" in _case_text(t.fused_source, head)


def test_linked_program_runs_call_indirect_in_case():
    """The linked program's loop body ends in its call_indirect, in a
    build without the tables' handlers."""
    from chip_smoke import make_engine

    prov, cons = build_linked_program()
    t = make_engine(cons, 2, device="cpu", fusion="blocks",
                    registered=(("prov", prov),))[0].tables
    assert not t.a3
    counts = fusegen.terminal_counts(t.fused_source)
    assert counts["call_indirect"] == 1
    heads = [pc for pc in range(t.hid.shape[0])
             if int(t.hid[pc]) >= fusion.H_BLOCK_BASE]
    ci = [pc for pc in heads
          if t.shapes[int(t.hid[pc]) - fusion.H_BLOCK_BASE][-1]
          == ("term", H_CALL_INDIRECT)]
    assert len(ci) == 1
    assert "call_op<kSimd>(p, s, w, os, CallLit{" in \
        _case_text(t.fused_source, ci[0])


def test_div_terminals_decide_their_trap_test():
    """The table zoo's div and rem terminals: a literal divisor decides
    the trap test when the source is generated, at the op's width (an
    i64 divisor 0x1_0000_0000 is not 0, 0xffff_ffff is not -1); a divisor
    that is not a literal keeps the agreed per-op test."""
    from wasmedge_tpu_torch.batch.interp import H_ALU2_BASE

    _, t = _blocks(build_table_zoo())
    src = t.fused_source
    seen = set()
    for pc in range(t.hid.shape[0]):
        h = int(t.hid[pc])
        if h < fusion.H_BLOCK_BASE:
            continue
        shape = t.shapes[h - fusion.H_BLOCK_BASE]
        if shape[-1] not in [("term", d) for d in fusegen._DIVS]:
            continue
        text = _case_text(src, pc)
        lit = None
        if shape[-2][0] == "const":
            last = [ln for ln in text.split("\n") if "= 0x" in ln][-1]
            lit = int(last.split("= ")[1].rstrip("ul;"), 16)
        test = "zero" if "trap = E_DIV_ZERO;" in text else \
            "agreed" if "w.agree((u32)r" in text else "none"
        seen.add((shape[-1][1] - H_ALU2_BASE, lit, test))
    i32_rem_u, i32_div_s, i32_div_u, i32_rem_s = 6, 3, 4, 5
    i64_rem_u, i64_div_s = 31, 28
    assert seen == {
        (i32_rem_u, 0, "zero"), (i32_div_s, 0xFFFFFFFF, "agreed"),
        (i64_rem_u, 0, "zero"), (i64_div_s, (1 << 64) - 1, "agreed"),
        (i64_div_s, 1 << 32, "none"), (i64_rem_u, 0xFFFFFFFF, "none"),
        (i32_rem_u, 9, "none"), (i32_div_u, None, "agreed"),
        (i32_rem_s, None, "agreed")}


@pytest.mark.parametrize("name", ["tail_dispatch", "zoo", "chain"])
def test_planner_shapes_equal_jax(name):
    data = {"tail_dispatch": build_tail_dispatch, "zoo": build_table_zoo,
            "chain": lambda: parse_wat(WAT_CHAIN)}[name]()
    ref_img = _ref_image(data)
    img = _image_of(ref_img)
    hid = hid_plane(img)
    got_hid, got_shapes = fusion.fuse_blocks(hid, img)
    want_hid, want_shapes = P.fuse_blocks(hid, ref_img)
    assert got_shapes == want_shapes
    assert ((got_hid >= fusion.H_BLOCK_BASE)
            == (want_hid >= P.H_BLOCK_BASE)).all()


# -- the tail dispatch per launch ---------------------------------------------

_TRAJ = {}


def _traj(key, data, func, args, chunk, knobs, fuel=None, cost=None):
    if key not in _TRAJ:
        _TRAJ[key] = ref_trajectory(data, func, args, chunk, knobs, fuel,
                                    cost)
    return _TRAJ[key]


TAIL_CONFIGS = [("blocks", None, None, False), ("blocks", False, False, False),
                ("blocks", None, False, True), ("blocks", False, None, True),
                ("none", None, None, True), ("none", False, False, False)]


@pytest.mark.parametrize("mode", ["converged", "divergent"])
@pytest.mark.parametrize("fusion_,optimistic,mem_hbm,gas", TAIL_CONFIGS)
def test_tail_dispatch_every_launch(mode, fusion_, optimistic, mem_hbm, gas):
    fuel, cost = (FUEL, tail_cost_table()) if gas else (None, None)
    args = tail_dispatch_args(LANES, mode, N)
    traj = _traj(("tail", mode, gas), build_tail_dispatch(), "run", args,
                 CHUNK, {}, fuel, cost)
    eng, port = port_replay(build_tail_dispatch(), traj, CHUNK, {}, fusion_,
                            optimistic, mem_hbm, f"tail {mode} gas={gas}",
                            fuel=fuel, cost=cost)
    trap = port.trap.numpy()
    if gas:
        assert (trap == int(ErrCode.CostLimitExceeded)).all()
    else:
        assert (trap == -1).all()
        got = port.stack_lo[0].numpy().astype(np.int64) & 0xFFFFFFFF
        assert (got == tail_dispatch_model(args[0], N)).all()


# -- chains at the budget's and the fuel's edges ------------------------------

@pytest.mark.parametrize("edge", ["chunk", "fuel", "gas"])
@pytest.mark.parametrize("delta", [-2, -1, 0, 1])
def test_chain_budget_edges(edge, delta):
    """A launch or a fuel budget that ends one op before the chained call,
    at it and after it: the case runs only when the whole chain (and its
    weight) fits, so a lane stops on the right op; fuel that runs out on
    the chained call traps there with its writes kept.  Per op (careful:
    every plane) and in blocks (kOpt and careful: rows below sp) against
    the JAX package, every launch."""
    data = parse_wat(WAT_CHAIN)
    args = [np.arange(LANES, dtype=np.int64) % 7]
    n, weight = 5, 9  # lget, lget, const, rem_u and the call (weight 5)
    chunk, fuel, cost = 64, None, None
    if edge == "chunk":
        chunk = n + delta
    else:
        cost = tail_cost_table() if edge == "gas" else None
        fuel = (weight if edge == "gas" else n) + delta
    traj = _traj(("chain", edge, delta), data, "chain", args, chunk, {},
                 fuel, cost)
    for fusion_, opt in (("none", False), ("blocks", None),
                         ("blocks", False)):
        eng, _ = port_replay(data, traj, chunk, {}, fusion_, opt, None,
                             f"chain {edge} {delta}", fuel=fuel, cost=cost)
    tb = eng.tables
    entry = [pc for pc, c in fusegen.chains(
        tb.hid.numpy(), tb.hid0.numpy(), tb.shapes).items()
        if int(tb.hid0[c]) == H_CALL_INDIRECT]
    assert [int(tb.flen[pc]) for pc in entry] == [n]
    first = {k: np.asarray(v) for k, v in traj[3][0][1].items()}
    if edge == "chunk":
        # the first launch stops `chunk` ops in, or at a call that traps
        live = first["trap"] == 0
        assert (first["retired"][live] == chunk).all()
        assert (first["retired"][~live] == n).all() and live.any()
    elif delta <= 0:
        # flat fuel runs out on the op it reaches; the call's weight (5)
        # takes the rest of any of these budgets on the call, where the
        # call's own trap, if any, wins over the fuel's
        on_call = delta == 0 or edge == "gas"
        assert (first["retired"] == (n if on_call else n + delta)).all()
        cost_out = first["trap"] == int(ErrCode.CostLimitExceeded)
        assert cost_out.all() if not on_call else \
            (cost_out.any() and (first["trap"] > 0).all())


# -- every trap of the new terminals ------------------------------------------

ZOO = table_terminal_cases(LANES, SEED)
ZOO_PARAMS = [(name, *cfg) for name in ZOO
              for cfg in (("blocks", None, None), ("blocks", False, False))
              ] + [(name, "none", None, False) for name in ("ci", "chain")]


def _zoo_traj(name):
    func, args = ZOO[name]
    return _traj(("zoo", name), build_table_zoo(), func, args, ZOO_CHUNK,
                 ZOO_KNOBS)


@pytest.mark.parametrize("name,fusion_,optimistic,mem_hbm", ZOO_PARAMS)
def test_terminal_cases_every_launch(name, fusion_, optimistic, mem_hbm):
    eng, port = port_replay(build_table_zoo(), _zoo_traj(name), ZOO_CHUNK,
                            ZOO_KNOBS, fusion_, optimistic, mem_hbm,
                            f"zoo {name}")
    assert eng.tables.a3 and eng.tables.tmut


def test_terminal_cases_reach_every_trap():
    """The cases' outcomes (the JAX runs): the five trap codes of a
    call_indirect terminal, chained or not, and the four of a
    return_call_indirect (CallStackExhausted comes from the callee), a
    literal-zero rem_u in every lane, div_s by -1 at INT_MIN (i32 and
    i64), no trap from i64 divisors 0x1_0000_0000 and 0xffff_ffff, a
    divisor 0 before a chained call."""
    def traps(name):
        return set(_zoo_traj(name)[3][-1][1]["trap"].tolist())

    E = ErrCode
    calls = {int(E.UndefinedElement), int(E.UninitializedElement),
             int(E.IndirectCallTypeMismatch), int(E.CallStackExhausted),
             int(E.StackOverflow)}
    for name in ("ci", "rci", "chain", "tchain"):
        assert calls <= traps(name) <= calls | {-1}, name
    assert traps("remz") == traps("remz64") == {int(E.DivideByZero)}
    assert traps("divm") == traps("divm64") == {-1, int(E.IntegerOverflow)}
    assert traps("divw64") == {-1}
    assert traps("dchain") == traps("rchain") == {-1, int(E.DivideByZero)}
