"""Tables, element and data segments, tail calls and ref.func on the port against the JAX package.

Checks, all bit-exact:

  - per launch: the reference's image and initial state are carried into
    the port; the reference SIMT `BatchEngine.run_from_state`
    (superinstruction fusion and tier-up off) and the port's plain engine
    each make one launch, and every plane (`tab`, `tsize`, `edrop` and
    `ddrop` included) must be equal after every launch (the stack's rows
    below sp where a fused dispatch or a rollback leaves dead rows
    above), per-op with `optimistic` on and off and `mem_hbm` on and off,
    and in B2 blocks and B6 superinstructions; on the table zoo
    (`models.fixtures.build_table_zoo`, every class and trap code) and on
    the WAT sources of `tests/test_table_batch.py` built with the port's
    own `utils/wat.py`;
  - results and traps against the scalar oracle (`wasmedge_tpu`'s
    executor, one fresh instance per lane);
  - B3: lanes of one warp that call one index of tables that differ roll
    back (the handle is agreed, not only the index); a table write in a
    warp that is on waits for a commit and leaves it off;
  - the B2 planner ends a block at every table, segment, tail-call and
    ref.func class, so they run per op in block builds.

The reference trajectory of each case is computed once and replayed
against every port configuration.
"""

import numpy as np
import pytest

from wasmedge_tpu.batch.engine import BatchEngine as RefEngine
from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.configure import Proposal as RefProposal
from wasmedge_tpu.common.errors import TrapError as RefTrapError
from wasmedge_tpu_torch.batch.convert import state_from_reference
from wasmedge_tpu_torch.batch.engine import (
    BatchEngine, cost_plane, mem_window_of, optimistic_of)
from wasmedge_tpu_torch.batch.fusion import fuse_blocks
from wasmedge_tpu_torch.batch.image import (
    CLS_DATA_DROP, CLS_ELEM_DROP, CLS_MEMINIT, CLS_REFFUNC, CLS_RETCALL,
    CLS_RETCALL_INDIRECT, CLS_TABLE_COPY, CLS_TABLE_FILL, CLS_TABLE_GET,
    CLS_TABLE_GROW, CLS_TABLE_INIT, CLS_TABLE_SET, CLS_TABLE_SIZE)
from wasmedge_tpu_torch.batch.interp import device_tables, hid_plane
from wasmedge_tpu_torch.batch.optimistic import WarpState
from wasmedge_tpu_torch.common.configure import Configure, Proposal
from wasmedge_tpu_torch.executor.instantiate import instantiate
from wasmedge_tpu_torch.loader import Loader
from wasmedge_tpu_torch.models.fixtures import (
    TABLE_ZOO_CAP, build_table_zoo, table_cases)
from wasmedge_tpu_torch.runtime.store import StoreManager
from wasmedge_tpu_torch.utils.wat import parse_wat
from wasmedge_tpu_torch.validator import Validator
from tests.helpers import instantiate as ref_instantiate
from tests.test_table_batch import (
    WAT_BULK, WAT_MEMINIT, WAT_SETGET, WAT_TAIL)
from tests.test_torch_blocks import assert_live_planes
from tests.test_torch_interp import _assert_planes, _image_of, _ref_planes

D, CD = 64, 16
LANES = 40  # a whole warp and a part of one
SEED = 20261018
A3_CLASSES = (CLS_TABLE_GET, CLS_TABLE_SET, CLS_TABLE_SIZE, CLS_TABLE_GROW,
              CLS_TABLE_FILL, CLS_TABLE_COPY, CLS_TABLE_INIT, CLS_ELEM_DROP,
              CLS_MEMINIT, CLS_DATA_DROP, CLS_RETCALL, CLS_RETCALL_INDIRECT,
              CLS_REFFUNC)

WAT_CAPS = """(module (table 2 4 funcref)
  (func (export "go") (param i32) (result i32)
    (table.grow (ref.null func) (local.get 0))))"""
WAT_TAIL_INDIRECT = """(module
  (table 2 funcref)
  (type $t (func (param i32 i64) (result i64)))
  (func $acc (type $t)
    (if (result i64) (i32.eqz (local.get 0))
      (then (local.get 1))
      (else (return_call_indirect (type $t)
        (i32.sub (local.get 0) (i32.const 1))
        (i64.add (local.get 1) (i64.const 3))
        (i32.const 0)))))
  (elem (i32.const 0) $acc)
  (func (export "go") (param i32) (result i64)
    (return_call_indirect (type $t)
      (local.get 0) (i64.const 0) (local.get 0))))"""
WAT_TGET = """(module (table 2 funcref)
  (func (export "go") (param i32) (result i32)
    (table.get (local.get 0)) (ref.is_null)))"""

# case -> (module bytes, export, args, steps per launch, knobs)


def _cases():
    out = {}
    zoo = build_table_zoo()
    for name, (func, args) in table_cases(LANES, SEED).items():
        out[f"zoo.{name}"] = (zoo, func, args, 64,
                              dict(table_elems_per_lane=TABLE_ZOO_CAP))
    lane = np.arange(LANES)
    out.update({
        "setget": (parse_wat(WAT_SETGET), "go",
                   [lane % 2, np.array([2, 2, 3, 3, 1, 1, 9, 0] * 5)], 64,
                   {}),
        "bulk": (parse_wat(WAT_BULK), "go",
                 [np.array([4, 4, 2, 4, 0, 4, 4, 1] * 5)], 64, {}),
        "caps": (parse_wat(WAT_CAPS), "go",
                 [np.array([0, 1, 2, 3, 2, 1, 0, 100] * 5)], 64, {}),
        "meminit": (parse_wat(WAT_MEMINIT), "go", [lane * 16, lane % 2], 64,
                    {}),
        "tail": (parse_wat(WAT_TAIL), "go", [lane * 3], 128, {}),
        "tail_indirect": (parse_wat(WAT_TAIL_INDIRECT), "go",
                          [np.array([0, 1, 2, 0, 5, 0, 1, 0] * 5)], 64, {}),
        "tget": (parse_wat(WAT_TGET), "go",
                 [np.array([0, 1, 2, 5, 0, 1, 2, 5] * 5)], 64, {}),
    })
    return out


CASES = _cases()
# the port configurations: (fusion, optimistic, mem_hbm); per-op in all
# four B3 and memory modes, blocks and super in two each on the zoo
PER_OP = [("none", o, m) for o in (None, False) for m in (None, False)]
FUSED = [("blocks", None, None), ("blocks", False, False),
         ("super", None, False), ("super", False, None)]
FUSED_CASES = ("zoo.copy", "zoo.meminit", "zoo.tail_ind", "zoo.agree",
               "zoo.grow", "setget", "tail")
# modules without a memory: mem_hbm changes nothing there
NO_MEMORY = ("setget", "bulk", "caps", "tail", "tail_indirect", "tget")
PARAMS = [(name, *cfg) for name in CASES
          for cfg in PER_OP + (FUSED if name in FUSED_CASES else [])
          if not (name in NO_MEMORY and cfg[2] is False)]


def _ref_conf(chunk, knobs, fuel=None, cost=None):
    conf = RefConfigure()
    conf.add_proposal(RefProposal.TailCall)
    b = conf.batch
    b.steps_per_launch = chunk
    b.value_stack_depth, b.call_stack_depth = D, CD
    b.memory_pages_per_lane = 1
    b.fuse_superinstructions = False
    b.tierup = False
    b.fuel_per_launch = fuel
    b.cost_table = cost
    for k, v in knobs.items():
        setattr(b, k, v)
    return conf


def _port_conf(chunk, knobs, fuel=None, cost=None):
    conf = Configure()
    conf.add_proposal(Proposal.TailCall)
    b = conf.batch
    b.steps_per_launch = chunk
    b.value_stack_depth, b.call_stack_depth = D, CD
    b.memory_pages_per_lane = 1
    b.fuel_per_launch = fuel
    b.cost_table = cost
    for k, v in knobs.items():
        setattr(b, k, v)
    return conf


def port_engine(data, lanes, conf):
    mod = Validator(conf).validate(Loader(conf).parse_module(data))
    store = StoreManager()
    inst = instantiate(store, mod, conf)
    return BatchEngine(inst, store=store, conf=conf, lanes=lanes,
                       device="cpu"), inst


_REF = {}


def ref_engine(data, lanes, chunk, knobs, fuel=None, cost=None):
    """One reference engine per module, geometry and knobs, shared by the
    cases that run on it: one compile."""
    key = (data, lanes, chunk, tuple(sorted(knobs.items())), fuel, cost)
    if key not in _REF:
        conf = _ref_conf(chunk, knobs, fuel, cost)
        _, store, inst = ref_instantiate(data, conf)
        _REF[key] = RefEngine(inst, store=store, conf=conf, lanes=lanes)
    return _REF[key]


def ref_trajectory(data, func, args, chunk, knobs, fuel=None, cost=None,
                   max_calls=400):
    """The reference run launch by launch: (engine, image, initial
    planes, [(total, planes)] after each launch)."""
    ref = ref_engine(data, len(np.asarray(args[0])), chunk, knobs, fuel,
                     cost)
    st = ref.initial_state(ref.export_func_idx(func),
                           [np.asarray(a, np.int64) for a in args])
    start = _ref_planes(st)
    steps, total = [], 0
    for _ in range(max_calls):
        st, total = ref.run_from_state(st, total, total + 1)
        steps.append((total, _ref_planes(st)))
        if not (np.asarray(st.trap) == 0).any():
            break
    else:
        raise AssertionError(f"reference still running after {max_calls} "
                             f"launches")
    return ref, ref.img, start, steps


def port_replay(data, traj, chunk, knobs, fusion, optimistic, mem_hbm,
                where, fuel=None, cost=None, each=None):
    """The port's plain engine from the reference's image and state, one
    launch per step of the trajectory, every plane equal after each.
    `each(before, after)` is called on the port's planes around every
    launch.  Returns (engine, final state)."""
    _, img, start, steps = traj
    lanes = start["pc"].shape[0]
    conf = _port_conf(chunk, knobs, fuel, cost)
    conf.batch.optimistic, conf.batch.mem_hbm = optimistic, mem_hbm
    eng, _ = port_engine(data, lanes, conf)
    eng.img = _image_of(img)
    eng.tables = device_tables(
        eng.img, "cpu", fusion, mem_window=mem_window_of(mem_hbm, eng.img),
        optimistic=optimistic_of(optimistic), stack_depth=D,
        cost=cost_plane(eng.img, eng.cfg))
    eng.warps = WarpState.new(lanes, "cpu") if eng.tables.optimistic \
        else None
    port = state_from_reference(start, device="cpu")
    total = 0
    for call, (want_total, want) in enumerate(steps):
        before = port.to_numpy()
        port, total = eng.run_from_state(port, total, total + 1)
        at = f"{where} [{fusion}, opt={optimistic}, hbm={mem_hbm}] " \
            f"launch {call}"
        assert total == want_total, at
        got = port.to_numpy()
        if fusion == "none" and not eng.tables.optimistic:
            _assert_planes(got, want, at)
        else:
            assert_live_planes(got, want, at)
        if each is not None:
            each(before, got)
    return eng, port


_TRAJ = {}


def _trajectory(name):
    if name not in _TRAJ:
        data, func, args, chunk, knobs = CASES[name]
        _TRAJ[name] = ref_trajectory(data, func, args, chunk, knobs)
    return _TRAJ[name]


@pytest.mark.parametrize("name,fusion,optimistic,mem_hbm", PARAMS)
def test_tables_match_simt_every_launch(name, fusion, optimistic, mem_hbm):
    data, func, args, chunk, knobs = CASES[name]
    traj = _trajectory(name)
    eng, port = port_replay(data, traj, chunk, knobs, fusion, optimistic,
                            mem_hbm, name)
    assert eng.tables.a3
    if eng.tables.optimistic:
        w = eng.warps
        assert int(w.rollbacks.sum()) <= int(w.entered.sum())


def _scalar(data, func, args):
    """The scalar oracle's (trap code or -1, raw result) for each lane."""
    out = []
    for lane in range(len(np.asarray(args[0]))):
        conf = RefConfigure()
        conf.add_proposal(RefProposal.TailCall)
        conf.batch.table_elems_per_lane = TABLE_ZOO_CAP
        ex, st, inst = ref_instantiate(data, conf)
        try:
            res = ex.invoke_raw(st, inst.find_func(func),
                                [int(np.asarray(a)[lane]) for a in args])
            out.append((-1, int(res[0]) & 0xFFFFFFFF if res else None))
        except RefTrapError as te:
            out.append((int(te.code), None))
    return out


@pytest.mark.parametrize("name", ["zoo.get", "zoo.calli", "zoo.set",
                                  "zoo.copy", "zoo.init", "zoo.meminit",
                                  "zoo.tail_ind", "zoo.refs", "setget",
                                  "tail", "tail_indirect"])
def test_results_and_traps_match_the_scalar_oracle(name):
    """The port's final trap and result per lane equal one fresh scalar
    instance per lane.  (Left out: growth, where the batch capacity is the
    knob and the scalar table's the declared max, and `zoo.tail`, whose
    StackOverflow comes from the batch's 64-slot value stack.)"""
    data, func, args, chunk, knobs = CASES[name]
    conf = _port_conf(chunk, knobs)
    eng, _ = port_engine(data, LANES, conf)
    res = eng.run(func, [np.asarray(a, np.int64) for a in args],
                  max_steps=10**6)
    want = _scalar(data, func, args)
    for lane, (trap, val) in enumerate(want):
        assert int(res.trap[lane]) == trap, (name, lane)
        if trap == -1 and val is not None:
            assert int(res.results[0][lane]) & 0xFFFFFFFF == val, (name,
                                                                   lane)
    # every outcome appears: traps and finished lanes
    assert (res.trap == -1).any()


def test_zoo_covers_every_class_and_trap():
    """The zoo holds every table, segment, tail-call and ref.func class,
    and its cases end in every trap code the classes raise."""
    conf = _port_conf(64, dict(table_elems_per_lane=TABLE_ZOO_CAP))
    eng, _ = port_engine(build_table_zoo(), LANES, conf)
    assert set(A3_CLASSES) <= set(np.unique(eng.img.cls).tolist())
    assert eng.img.table_cap == TABLE_ZOO_CAP < eng.img.table_max
    traps = set()
    for name in CASES:
        if name.startswith("zoo."):
            traps |= {int(t) for t in _trajectory(name)[3][-1][1]["trap"]}
    from wasmedge_tpu_torch.common.errors import ErrCode as E

    assert {int(E.TableOutOfBounds), int(E.UndefinedElement),
            int(E.UninitializedElement), int(E.IndirectCallTypeMismatch),
            int(E.StackOverflow), int(E.MemoryOutOfBounds), -1} <= traps


def test_handle_agreement_rolls_back_and_writes_leave_on():
    """B3: in `agree`, every lane of a warp writes table slot 1 (lanes
    differ), so a warp that is on commits and is off at the write; the
    next launch enters the warps on (same control registers, tsize
    equal) but not uniform (table rows differ), and call_indirect of
    slot 1 reaches different callees: the warps roll back."""
    data, func, args, chunk, knobs = CASES["zoo.agree"]
    eng, _ = port_replay(data, _trajectory("zoo.agree"), chunk, knobs,
                         "none", None, None, "agree")
    w = eng.warps
    assert int(w.entered.sum()) > 0
    assert int(w.rollbacks.sum()) > 0
    assert int(w.uniform.sum()) < int(w.entered.sum())


def test_uniform_warps_run_table_writes_in_place():
    """Lanes that hold one state (the same args) enter uniform at every
    launch, run the table and segment writes in place and never roll
    back."""
    data = build_table_zoo()
    args = [np.full(64, 3), np.full(64, 2), np.full(64, 2)]
    traj = ref_trajectory(data, "copy", args, 16,
                          dict(table_elems_per_lane=TABLE_ZOO_CAP))
    eng, _ = port_replay(data, traj, 16,
                         dict(table_elems_per_lane=TABLE_ZOO_CAP), "none",
                         None, None, "uniform copy")
    w = eng.warps
    assert int(w.entered.sum()) == int(w.uniform.sum()) > 2
    assert int(w.rollbacks.sum()) == 0


def test_blocks_end_at_every_table_class():
    """fuse_blocks' whitelist leaves every table, segment, tail-call and
    ref.func class out of a block: none is absorbed, and one that stops
    a block is its terminal, run per op."""
    conf = _port_conf(64, dict(table_elems_per_lane=TABLE_ZOO_CAP))
    eng, _ = port_engine(build_table_zoo(), LANES, conf)
    img = eng.img
    hid = hid_plane(img)
    fhid, shapes = fuse_blocks(hid, img)
    a3 = np.isin(img.cls, A3_CLASSES)
    assert a3.sum() > 13
    for s in shapes:
        for op in s[:-1]:
            assert op[0] != "term"
    terms = {op[1] for s in shapes for op in s if op[0] == "term"}
    assert terms & set(hid[a3].tolist())
    # no block head is an A3 slot, and no block body covers one
    assert (fhid[a3] == hid[a3]).all()
    from wasmedge_tpu_torch.batch.fusion import fused_lengths

    flen = fused_lengths(fhid, shapes)
    covered = np.zeros(img.code_len, bool)
    for pc in np.nonzero(flen)[0]:
        covered[pc:pc + flen[pc] - 1] = True
    assert not (covered & a3).any()
