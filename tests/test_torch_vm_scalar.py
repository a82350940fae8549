"""The port's VM on the host and its gas bridge, against the JAX VM.

- `execute` and `run_wasm_file` (bytes, a `.wat` file and a `.wasm` file
  under tmp_path) run the scalar engine on the host; `register_module`
  with a cross-module call and `execute(..., module_name=)`;
  `get_function_list`; `async_execute` and `async_run_wasm_file`;
  cancel and `stop()` on an infinite loop (each handle its own token, a
  timeout of its own), a stale stop that does not poison the next run;
  `cleanup` keeping registered modules; the stage machine's refusals:
  each with the JAX VM's results or error codes;
- `batch_conf_with_gas`, the port's and the JAX package's, for the same
  `Statistics` settings: the same fuel and cost table, or no gas;
- the start function's cost charged to the VM's `Statistics` at
  instantiation (and a limit below it trapping there), and
  `execute_batch` with a cost limit at 64 lanes, flat and with a
  non-uniform cost table, equal lane by lane (results, traps, retired)
  to the JAX VM's, with lanes that finish on the budget and lanes that
  trap `CostLimitExceeded` at the limit + 1.
"""

import os

import numpy as np
import pytest

from wasmedge_tpu.common.configure import Configure as RefConfigure
from wasmedge_tpu.common.errors import WasmError as RefWasmError
from wasmedge_tpu.common.statistics import Statistics as RefStatistics
from wasmedge_tpu.vm.vm import VM as RefVM
from wasmedge_tpu.vm.vm import batch_conf_with_gas as ref_bridge
from wasmedge_tpu_torch.common.configure import Configure
from wasmedge_tpu_torch.common.errors import ErrCode, TrapError, WasmError
from wasmedge_tpu_torch.common.opcodes import NAME_TO_ID
from wasmedge_tpu_torch.common.statistics import Statistics
from wasmedge_tpu_torch.models import build_fib
from wasmedge_tpu_torch.models.fixtures import (
    build_linked_program, linked_args, linked_program_model)
from wasmedge_tpu_torch.utils.builder import ModuleBuilder
from wasmedge_tpu_torch.vm import VM, VMStage
from wasmedge_tpu_torch.vm.vm import batch_conf_with_gas

LANES = 64
WAIT_S = 30.0  # the async tests' own time limit

FIB_WAT = """(module (func $fib (export "fib") (param i32) (result i32)
  (if (result i32) (i32.lt_s (local.get 0) (i32.const 2))
    (then (local.get 0))
    (else (i32.add (call $fib (i32.sub (local.get 0) (i32.const 1)))
                   (call $fib (i32.sub (local.get 0) (i32.const 2))))))))"""


def _spin():
    b = ModuleBuilder()
    b.add_function([], [], [], [("loop", None), ("br", 0), "end"],
                   export="spin")
    return b.build()


def _math():
    b = ModuleBuilder()
    b.add_function(["i32", "i32"], ["i32"], [], [
        ("local.get", 0), ("local.get", 1), "i32.add"], export="add")
    return b.build()


def _plus100():
    b = ModuleBuilder()
    b.import_func("math", "add", ["i32", "i32"], ["i32"])
    b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("i32.const", 100), ("call", 0)],
        export="plus100")
    return b.build()


def _both(fn):
    """fn(VM class) on both packages: results (ints) or error codes."""
    out = []
    for cls in (VM, RefVM):
        try:
            out.append([int(v) for v in fn(cls)])
        except (WasmError, RefWasmError) as e:
            out.append(("error", int(e.code)))
    assert out[0] == out[1]
    return out[0]


def test_execute_and_stages_like_jax():
    def staged(cls):
        vm = cls()
        assert vm.stage.name == "Inited"
        vm.load_wasm(build_fib())
        assert vm.stage.name == "Loaded"
        vm.validate()
        vm.instantiate()
        assert vm.stage.name == "Instantiated"
        return vm.execute("fib", [10]) + vm.execute("fib", [20])

    assert _both(staged) == [55, 6765]
    assert _both(lambda cls: cls().validate()) == \
        ("error", int(ErrCode.WrongVMWorkflow))
    assert _both(lambda cls: cls().load_wasm(build_fib()).instantiate()) == \
        ("error", int(ErrCode.WrongVMWorkflow))
    assert _both(lambda cls: cls().load_wasm(build_fib()).validate()
                 .instantiate().execute("nope")) == \
        ("error", int(ErrCode.FuncNotFound))
    assert _both(lambda cls: cls().execute("fib", [1])) == \
        ("error", int(ErrCode.WrongVMWorkflow))
    assert _both(lambda cls: cls().execute("f", [], module_name="none")) == \
        ("error", int(ErrCode.WrongInstanceAddress))


def test_run_wasm_file_from_bytes_wat_and_wasm(tmp_path):
    wat = tmp_path / "fib.wat"
    wat.write_text(FIB_WAT)
    wasm = tmp_path / "fib.wasm"
    wasm.write_bytes(build_fib())
    for source, n, want in ((build_fib(), 12, 144), (str(wat), 15, 610),
                            (str(wasm), 20, 6765)):
        assert _both(lambda cls: cls().run_wasm_file(source, "fib", [n])) \
            == [want]
    bad = tmp_path / "bad.wat"
    bad.write_text("(module (func (result i32)")  # unbalanced
    assert _both(lambda cls: cls().run_wasm_file(str(bad), "f")) == \
        ("error", int(ErrCode.IllegalGrammar))
    assert os.path.exists(wasm)


def test_register_module_and_cross_call():
    def run(cls):
        vm = cls()
        vm.register_module("math", _math())
        out = vm.run_wasm_file(_plus100(), "plus100", [5])
        return out + vm.execute("add", [2, 3], module_name="math")

    assert _both(run) == [105, 5]

    def twice(cls):
        vm = cls()
        vm.register_module("m", _math())
        vm.register_module("m", _math())
        return []

    assert _both(twice) == ("error", int(ErrCode.ModuleNameConflict))


def test_function_list_like_jax():
    vm = VM().load_wasm(build_fib()).validate().instantiate()
    rvm = RefVM().load_wasm(build_fib()).validate().instantiate()
    got = [(n, [int(t) for t in ft.params], [int(t) for t in ft.results])
           for n, ft in vm.get_function_list()]
    want = [(n, [int(t) for t in ft.params], [int(t) for t in ft.results])
            for n, ft in rvm.get_function_list()]
    assert got == want == [("fib", [0x7F], [0x7F])]
    assert VM().get_function_list() == []
    assert vm.active_module is vm._active and vm.statistics() is vm.stat


def test_async_execute_and_run_wasm_file():
    vm = VM().load_wasm(build_fib()).validate().instantiate()
    h = vm.async_execute("fib", [15])
    assert h.wait_for(WAIT_S) and h.done()
    assert h.get() == [610]
    h = VM().async_run_wasm_file(build_fib(), "fib", [12])
    assert h.wait_for(WAIT_S) and h.get() == [144]


@pytest.mark.parametrize("stop_with", ["cancel", "vm_stop"])
def test_cancel_interrupts_an_infinite_loop(stop_with):
    vm = VM().load_wasm(_spin()).validate().instantiate()
    h = vm.async_execute("spin")
    assert not h.wait_for(0.05)
    if stop_with == "cancel":
        h.cancel()
    else:
        vm.stop()
    assert h.wait_for(WAIT_S)
    with pytest.raises(TrapError) as e:
        h.get()
    assert e.value.code == ErrCode.Terminated


def test_cancel_is_per_handle():
    vm = VM().load_wasm(_spin()).validate().instantiate()
    h1, h2 = vm.async_execute("spin"), vm.async_execute("spin")
    try:
        h1.cancel()
        assert h1.wait_for(WAIT_S)
        assert not h2.done()
    finally:
        h2.cancel()
        assert h2.wait_for(WAIT_S)


def test_stale_stop_does_not_poison_the_next_run():
    def run(cls):
        vm = cls()
        out = vm.run_wasm_file(build_fib(), "fib", [10])
        vm.stop()  # after the run: no effect on the next
        return out + vm.execute("fib", [10])

    assert _both(run) == [55, 55]


def test_cleanup_keeps_registered_modules():
    def run(cls):
        b = ModuleBuilder()
        b.add_function([], ["i32"], [], [("i32.const", 7)], export="seven")
        vm = cls()
        vm.register_module("k", b.build())
        out = vm.run_wasm_file(build_fib(), "fib", [5])
        vm.cleanup()
        assert vm.stage.name == "Inited" and vm.active_module is None
        assert vm.statistics().instr_count == 0
        return out + vm.execute("seven", [], module_name="k")

    assert _both(run) == [5, 7]


# ---------------------------------------------------------------------------
# gas
# ---------------------------------------------------------------------------
def _weighted(table):
    for name, w in (("i32.add", 3), ("call_indirect", 5), ("i32.load", 2)):
        table[NAME_TO_ID[name]] = w


GAS_CASES = {
    "off": dict(cost_measuring=False, cost_limit=100),
    "unlimited": dict(cost_measuring=True),
    "at_int32": dict(cost_measuring=True, cost_limit=(1 << 31) - 1),
    "limit": dict(cost_measuring=True, cost_limit=1000),
    "weighted": dict(cost_measuring=True, cost_limit=5000, weighted=True),
    "preset_fuel": dict(cost_measuring=True, cost_limit=1 << 40, fuel=77),
    "weighted_unlimited": dict(cost_measuring=True, weighted=True),
}


@pytest.mark.parametrize("case", sorted(GAS_CASES))
def test_batch_conf_with_gas_like_jax(case):
    spec = dict(GAS_CASES[case])
    got = []
    for conf_cls, stat_cls, bridge in ((Configure, Statistics,
                                        batch_conf_with_gas),
                                       (RefConfigure, RefStatistics,
                                        ref_bridge)):
        conf = conf_cls()
        conf.statistics.cost_measuring = spec["cost_measuring"]
        if "cost_limit" in spec:
            conf.statistics.cost_limit = spec["cost_limit"]
        conf.batch.fuel_per_launch = spec.get("fuel")
        stat = stat_cls(conf)
        if spec.get("weighted"):
            _weighted(stat.cost_table)
        out = bridge(conf, stat)
        got.append((out is conf, out.batch.fuel_per_launch,
                    out.batch.cost_table, conf.batch.fuel_per_launch,
                    conf.batch.cost_table))
    assert got[0] == got[1]
    same, fuel = got[0][0], got[0][1]
    if case in ("off", "unlimited", "at_int32", "weighted_unlimited"):
        assert same and fuel is None
    elif case == "limit":
        assert fuel == 1001 and got[0][2] is None
    elif case == "weighted":
        assert fuel == 5001 and got[0][2][NAME_TO_ID["i32.add"]] == 3
    else:
        assert fuel == 77


def _linked_vms(limit, weighted=False):
    prov, cons = build_linked_program()
    vms = []
    for cls, conf_cls in ((VM, Configure), (RefVM, RefConfigure)):
        conf = conf_cls()
        conf.statistics.cost_measuring = True
        conf.statistics.instr_counting = True
        conf.statistics.cost_limit = limit
        conf.batch.steps_per_launch = 500
        conf.batch.value_stack_depth, conf.batch.call_stack_depth = 64, 16
        vm = cls(conf)
        if weighted:
            _weighted(vm.statistics().cost_table)
        vm.register_module("prov", prov)
        vm.load_wasm(cons)
        vm.validate()
        vms.append(vm)
    return vms


def test_start_function_is_charged_at_instantiation():
    costs = []
    for vm in _linked_vms(10**9):
        vm.instantiate()
        costs.append((vm.statistics().total_cost,
                      vm.statistics().instr_count))
    assert costs[0] == costs[1] and costs[0][0] > 10_000
    # a limit below the start function's cost traps in instantiate
    for vm in _linked_vms(3000):
        with pytest.raises((TrapError, RefWasmError)) as e:
            vm.instantiate()
        assert int(e.value.code) == int(ErrCode.CostLimitExceeded)


@pytest.mark.parametrize("weighted", [False, True])
def test_execute_batch_gas_like_jax(weighted):
    n0, n1 = 20, 6  # n = 20 .. 62
    args = linked_args(LANES, n0, n1)
    # the exact cost of lane group 3: 8 + 35 n instructions, flat
    limit = 8 + 35 * (n0 + 3 * n1)
    if weighted:
        limit += 2 * (n0 + 3 * n1) * 2  # room for the weights
    # the start function runs under a high limit; the lanes' budget is
    # the limit set after it (+ 1), whatever the start function cost
    port, ref = _linked_vms(10**9, weighted)
    for vm in (port, ref):
        vm.instantiate()
        vm.statistics().set_cost_limit(limit)
    got = port.execute_batch("run", args, lanes=LANES, device="cpu")
    want = ref.execute_batch("run", args, lanes=LANES)
    np.testing.assert_array_equal(got.trap, np.asarray(want.trap))
    np.testing.assert_array_equal(got.retired, np.asarray(want.retired))
    ok = got.trap == -1
    np.testing.assert_array_equal(
        np.asarray(got.results[0], np.int64)[ok] & 0xFFFFFFFF,
        np.asarray(want.results[0], np.int64)[ok] & 0xFFFFFFFF)
    model = linked_program_model(*args)
    assert ((np.asarray(got.results[0], np.int64) & 0xFFFFFFFF)[ok]
            == model[ok]).all()
    group = np.arange(LANES) % 8
    assert (got.trap[~ok] == int(ErrCode.CostLimitExceeded)).all()
    if not weighted:
        # groups 0-3 finish, group 3 exactly on the budget; groups 4-7
        # trap with retired = limit + 1
        assert ok[group <= 3].all() and (~ok[group >= 4]).all()
        assert (got.retired[group == 3] == limit).all()
        assert (got.retired[~ok] == limit + 1).all()
        assert port.last_engine.cost is None
    else:
        # the weights depend on the functions each lane calls: some lanes
        # finish, the others run out before their last instruction
        assert port.last_engine.cost is not None
        assert ok.any() and (~ok).any()
        assert (got.retired[~ok] < (8 + 35 * args[0])[~ok]).all()
