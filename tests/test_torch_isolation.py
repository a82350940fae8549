"""The port stands alone: nothing under wasmedge_tpu_torch/ (its host
modules under host/ and runtime/hostfunc.py, the v128 ops, the text
front-end, the corpus runner, the multi-tenant engines, the serving
layer, lane compaction, its divergence scores, checkpoints, the
supervisor, the lineage and the fault seams included) and nothing in chip_smoke.py
imports JAX or the JAX package, no entry point defaults to the CPU, and
the CUDA source's ids, v128 family offsets and trap codes equal the
Python package's, and no generated fused-kernel source is kept outside
the build directory."""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "wasmedge_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "wasmedge_tpu")


def test_source_walk_covers_the_host_modules():
    rel = {os.path.relpath(p, PKG) for p in _sources()}
    for f in ("runtime/hostfunc.py", "batch/hostcall.py",
              "host/wasi/__init__.py", "host/wasi/environ.py",
              "host/wasi/wasi_abi.py", "host/wasi/wasifunc.py",
              "host/wasi/vectorized.py", "batch/simdops.py", "utils/wat.py",
              "spec/__init__.py", "batch/fusion.py", "batch/fusegen.py",
              "common/statistics.py", "executor/executor.py",
              "executor/engine.py", "executor/numeric.py",
              "executor/simd.py", "vm/async_.py", "vm/vm.py",
              "batch/multitenant.py", "serve/queue.py", "serve/recycle.py",
              "serve/server.py", "analysis/cfg.py", "analysis/analyzer.py",
              "batch/compact.py", "batch/checkpoint.py", "utils/fsio.py",
              "batch/lineage.py", "batch/supervisor.py",
              "testing/faults.py"):
        assert f in rel, f


def test_no_generated_cuda_source_outside_the_build_dir():
    """The fused kernels' sources are generated per module into _build/
    (ignored by git); none is kept beside the repository's sources."""
    from wasmedge_tpu_torch.batch import fusegen

    mark = fusegen._HEAD.splitlines()[0]
    # the directories git ignores (build outputs, caches) and .git
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        ignored = {ln.strip().rstrip("/") for ln in fh
                   if ln.strip().endswith("/")}
    found = []
    for d, dirs, files in os.walk(ROOT):
        rel = os.path.relpath(d, ROOT)
        dirs[:] = [x for x in dirs if x != ".git" and x not in ignored
                   and os.path.normpath(os.path.join(rel, x)) not in ignored]
        for f in files:
            if f.endswith((".cu", ".cuh", ".cpp", ".h")):
                with open(os.path.join(d, f), errors="replace") as fh:
                    if fh.readline().rstrip("\n") == mark:
                        found.append(os.path.relpath(os.path.join(d, f),
                                                     ROOT))
    assert not found, found
    src = fusegen.cuda_source([], (), False, False)
    assert src.splitlines()[0] == mark
    with open(os.path.join(ROOT, ".gitignore")) as fh:
        assert "wasmedge_tpu_torch/_build/" in fh.read().split()


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            assert not _forbidden(n), f"{path}:{node.lineno} imports {n}"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_entry_point_defaults_to_the_cpu(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = node.args
        pos = args.posonlyargs + args.args
        pairs = list(zip(pos[len(pos) - len(args.defaults):], args.defaults))
        pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            if arg.arg == "device" and isinstance(default, ast.Constant):
                assert default.value != "cpu", \
                    f"{path}:{node.lineno} {node.name} defaults to the CPU"


def test_cuda_source_constants_match_python():
    from wasmedge_tpu_torch.batch import interp
    from wasmedge_tpu_torch.batch.image import NUM_ALU1, NUM_ALU2
    from wasmedge_tpu_torch.common.errors import ErrCode

    src = open(os.path.join(PKG, "csrc", "interp.cu")).read()
    consts = {m.group(1): int(m.group(2), 0) for m in re.finditer(
        r"constexpr int (\w+) = (-?(?:0x[0-9A-Fa-f]+|\d+));", src)}
    for name, val in consts.items():
        if name.startswith("H_"):
            assert getattr(interp, name) == val, name
    assert consts["NUM_ALU1"] == NUM_ALU1 and consts["NUM_ALU2"] == NUM_ALU2
    assert consts["NUM_HANDLERS"] == interp.NUM_HANDLERS
    from wasmedge_tpu_torch.batch.simdops import V1_SUB, V2_SUB

    first = {"V2_I8X16": "i8x16.add", "V2_I16X8": "i16x8.add",
             "V2_I32X4": "i32x4.add", "V2_I64X2": "i64x2.add",
             "V2_F32X4": "f32x4.add", "V2_F64X2": "f64x2.add",
             "V2_NARROW": "i8x16.narrow_i16x8_s",
             "V2_EXTMUL": "i16x8.extmul_low_i8x16_s",
             "V1_F32X4": "f32x4.abs", "V1_F64X2": "f64x2.abs",
             "V1_CONVERT": "i32x4.trunc_sat_f32x4_s",
             "V1_EXTEND": "i16x8.extend_low_i8x16_s",
             "V1_EXTADD": "i16x8.extadd_pairwise_i8x16_s"}
    for name, op in first.items():
        table = V2_SUB if name.startswith("V2") else V1_SUB
        assert consts[name] == table[op], name
    codes = {"E_DIV_ZERO": "DivideByZero", "E_INT_OVERFLOW": "IntegerOverflow",
             "E_INVALID_CONV": "InvalidConvToInt",
             "E_MEM_OOB": "MemoryOutOfBounds",
             "E_UNINIT_ELEM": "UninitializedElement",
             "E_UNDEF_ELEM": "UndefinedElement",
             "E_SIG_MISMATCH": "IndirectCallTypeMismatch",
             "E_CALL_STACK": "CallStackExhausted",
             "E_STACK_OVERFLOW": "StackOverflow",
             "E_COST_LIMIT": "CostLimitExceeded",
             "E_EXEC_FAILED": "ExecutionFailed"}
    for c, e in codes.items():
        assert consts[c] == int(getattr(ErrCode, e)), c
    assert consts["TRAP_DONE"] == interp.TRAP_DONE
    assert consts["TRAP_HOSTCALL"] == interp.TRAP_HOSTCALL
