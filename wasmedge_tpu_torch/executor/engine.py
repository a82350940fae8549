"""Scalar engine: the dispatch loop over the lowered image.

A copy of `wasmedge_tpu/executor/engine.py`.  It mirrors the interpreter
loop (WasmEdge lib/executor/engine/
engine.cpp:68-1641): `while pc != end` over a flat instruction array, with
Statistics hooks and a StopToken check at calls and branches
(lib/executor/helper.cpp:24,184). It is what `VM.execute` and
`run_wasm_file` run on the host, what runs a start function at
instantiation, and the scalar spec harness's engine.

Execution state is exactly the SoA the device engine uses, in scalar form:
pc, fp, operand/locals stack (raw 64-bit cells), frame stack. Branches are
{target_pc, keep, pop_to} descriptors; calls are fp-relative frame pushes
(reference analog: stackmgr.h:80-128, helper.cpp:153-176).
"""

from __future__ import annotations

from typing import List, Optional

from wasmedge_tpu_torch.common.errors import ErrCode, TrapError, trap
from wasmedge_tpu_torch.common.opcodes import Op
from wasmedge_tpu_torch.common.types import MASK32, MASK64, s32
from wasmedge_tpu_torch.executor.numeric import HANDLERS
from wasmedge_tpu_torch.executor import simd as _simd
from wasmedge_tpu_torch.runtime.instance import FunctionInstance, ModuleInstance
from wasmedge_tpu_torch.validator.image import LOP_BR, LOP_BRNZ, LOP_BRZ

OP_RETURN = Op.__dict__["return"]
MASK128 = (1 << 128) - 1

# Load/store op metadata: op -> (nbytes, signed, result mask)
_LOAD_INFO = {
    Op.i32_load: (4, False, MASK32), Op.i64_load: (8, False, MASK64),
    Op.f32_load: (4, False, MASK32), Op.f64_load: (8, False, MASK64),
    Op.i32_load8_s: (1, True, MASK32), Op.i32_load8_u: (1, False, MASK32),
    Op.i32_load16_s: (2, True, MASK32), Op.i32_load16_u: (2, False, MASK32),
    Op.i64_load8_s: (1, True, MASK64), Op.i64_load8_u: (1, False, MASK64),
    Op.i64_load16_s: (2, True, MASK64), Op.i64_load16_u: (2, False, MASK64),
    Op.i64_load32_s: (4, True, MASK64), Op.i64_load32_u: (4, False, MASK64),
}
_STORE_INFO = {
    Op.i32_store: 4, Op.i64_store: 8, Op.f32_store: 4, Op.f64_store: 8,
    Op.i32_store8: 1, Op.i32_store16: 2,
    Op.i64_store8: 1, Op.i64_store16: 2, Op.i64_store32: 4,
}

# SIMD wide loads: op -> (src lane bytes, lane count, signed) for NxM loads
_SIMD_EXT_LOAD = {
    Op.v128_load8x8_s: (1, 8, True), Op.v128_load8x8_u: (1, 8, False),
    Op.v128_load16x4_s: (2, 4, True), Op.v128_load16x4_u: (2, 4, False),
    Op.v128_load32x2_s: (4, 2, True), Op.v128_load32x2_u: (4, 2, False),
}
_SIMD_SPLAT_LOAD = {
    Op.v128_load8_splat: 1, Op.v128_load16_splat: 2,
    Op.v128_load32_splat: 4, Op.v128_load64_splat: 8,
}
_SIMD_ZERO_LOAD = {Op.v128_load32_zero: 4, Op.v128_load64_zero: 8}
_SIMD_LANE_LOAD = {
    Op.v128_load8_lane: 1, Op.v128_load16_lane: 2,
    Op.v128_load32_lane: 4, Op.v128_load64_lane: 8,
}
_SIMD_LANE_STORE = {
    Op.v128_store8_lane: 1, Op.v128_store16_lane: 2,
    Op.v128_store32_lane: 4, Op.v128_store64_lane: 8,
}
# lane access: op -> (shape, signed, result mask or None for v128 result)
_SIMD_EXTRACT = {
    Op.i8x16_extract_lane_s: ("i8x16", True, MASK32),
    Op.i8x16_extract_lane_u: ("i8x16", False, MASK32),
    Op.i16x8_extract_lane_s: ("i16x8", True, MASK32),
    Op.i16x8_extract_lane_u: ("i16x8", False, MASK32),
    Op.i32x4_extract_lane: ("i32x4", False, MASK32),
    Op.i64x2_extract_lane: ("i64x2", False, MASK64),
    Op.f32x4_extract_lane: ("f32x4", False, MASK32),
    Op.f64x2_extract_lane: ("f64x2", False, MASK64),
}
_SIMD_REPLACE = {
    Op.i8x16_replace_lane: "i8x16", Op.i16x8_replace_lane: "i16x8",
    Op.i32x4_replace_lane: "i32x4", Op.i64x2_replace_lane: "i64x2",
    Op.f32x4_replace_lane: "f32x4", Op.f64x2_replace_lane: "f64x2",
}


class Thread:
    """One scalar execution context (stack + frames + module cursor)."""

    __slots__ = ("store", "conf", "stat", "stack", "frames", "stop_token",
                 "max_call_depth")

    def __init__(self, store, conf, stat=None):
        self.store = store
        self.conf = conf
        self.stat = stat
        self.stack: List[int] = []
        self.frames: List[tuple] = []
        self.stop_token = False
        self.max_call_depth = conf.runtime.max_call_depth


def run_function(thread: Thread, fi: FunctionInstance, args: List[int]) -> List[int]:
    """Invoke a wasm or host function with raw-cell args; returns raw cells."""
    if fi.kind == "host":
        mem = fi.module.memories[0] if (fi.module and fi.module.memories) else None
        return fi.host.run(mem, list(args))
    return _run_wasm(thread, fi, args)


def _run_wasm(thread: Thread, fi: FunctionInstance, args: List[int]) -> List[int]:
    module = fi.module
    image = module.lowered
    meta = image.funcs[fi.func_idx]
    st = thread.stack
    frames = thread.frames
    base_frames = len(frames)
    stat = thread.stat

    # Entry frame: locals at fp, zero-initialized non-params.
    fp = len(st)
    st.extend(args)
    st.extend([0] * (meta.nlocals - meta.nparams))
    opbase = fp + meta.nlocals
    frames.append((-1, -1, -1, None))  # sentinel
    pc = meta.entry_pc

    ops = image.op
    aa = image.a
    bb = image.b
    cc = image.c
    imm = image.imm
    brt = image.br_table
    v128c = image.v128
    funcs = module.funcs
    memories = module.memories
    globals_ = module.globals
    tables = module.tables
    elems = module.elems
    datas = module.datas
    count_stats = stat is not None and (stat.instr_counting or stat.cost_measuring)

    while True:
        op = ops[pc]
        if count_stats:
            if stat.instr_counting:
                stat.inc_instr()
            if stat.cost_measuring:
                stat.add_instr_cost(op)

        h = HANDLERS.get(op)
        if h is not None:  # numeric fast path
            h(st)
            pc += 1
            continue

        if op == Op.local_get:
            st.append(st[fp + aa[pc]])
            pc += 1
        elif op == Op.local_set:
            st[fp + aa[pc]] = st.pop()
            pc += 1
        elif op == Op.local_tee:
            st[fp + aa[pc]] = st[-1]
            pc += 1
        elif op in (Op.i32_const, Op.i64_const, Op.f32_const, Op.f64_const):
            st.append(imm[pc] if imm[pc] >= 0 else imm[pc] + (1 << 64))
            pc += 1
        elif op == LOP_BR:
            if thread.stop_token:
                trap(ErrCode.Terminated)
            keep = bb[pc]
            kept = st[len(st) - keep:] if keep else []
            del st[opbase + cc[pc]:]
            st.extend(kept)
            pc = aa[pc]
        elif op == LOP_BRZ:
            if st.pop() == 0:
                pc = aa[pc]
            else:
                pc += 1
        elif op == LOP_BRNZ:
            if st.pop() != 0:
                if thread.stop_token:
                    trap(ErrCode.Terminated)
                keep = bb[pc]
                kept = st[len(st) - keep:] if keep else []
                del st[opbase + cc[pc]:]
                st.extend(kept)
                pc = aa[pc]
            else:
                pc += 1
        elif op == Op.br_table:
            if thread.stop_token:
                trap(ErrCode.Terminated)
            i = st.pop() & MASK32
            n = bb[pc]
            entry = (aa[pc] + (i if i < n else n)) * 3
            keep = brt[entry + 1]
            kept = st[len(st) - keep:] if keep else []
            del st[opbase + brt[entry + 2]:]
            st.extend(kept)
            pc = brt[entry]
        elif op == OP_RETURN:
            n = bb[pc]
            results = st[len(st) - n:] if n else []
            del st[fp:]
            st.extend(results)
            ret_pc, prev_fp, prev_opbase, prev_module = frames.pop()
            if len(frames) == base_frames:
                out = st[len(st) - n:] if n else []
                del st[len(st) - n:]
                return out
            pc, fp, opbase = ret_pc, prev_fp, prev_opbase
            if prev_module is not None and prev_module is not module:
                module = prev_module
                image = module.lowered
                ops, aa, bb, cc, imm = image.op, image.a, image.b, image.c, image.imm
                brt = image.br_table
                v128c = image.v128
                funcs, memories = module.funcs, module.memories
                globals_, tables = module.globals, module.tables
                elems, datas = module.elems, module.datas
        elif op in (Op.call, Op.call_indirect, Op.return_call,
                    Op.return_call_indirect):
            if thread.stop_token:
                trap(ErrCode.Terminated)
            tail = op in (Op.return_call, Op.return_call_indirect)
            if op in (Op.call, Op.return_call):
                callee = funcs[aa[pc]]
            else:
                tab = tables[bb[pc]]
                i = st.pop() & MASK32
                if i >= tab.size:
                    trap(ErrCode.UndefinedElement)
                href = tab.refs[i]
                if href == 0:
                    trap(ErrCode.UninitializedElement)
                callee = thread.store.deref_func(href)
                if callee is None:
                    trap(ErrCode.UninitializedElement)
                if callee.functype != module.ast.types[aa[pc]]:
                    trap(ErrCode.IndirectCallTypeMismatch)

            if callee.kind == "host":
                hf = callee.host
                nargs = len(hf.functype.params)
                raw = st[len(st) - nargs:] if nargs else []
                del st[len(st) - nargs:]
                if stat is not None and stat.cost_measuring:
                    stat.add_cost(hf.cost)
                mem = memories[0] if memories else None
                if stat is not None:
                    stat.stop_wasm()
                    stat.start_host()
                try:
                    res = hf.run(mem, raw)
                finally:
                    if stat is not None:
                        stat.stop_host()
                        stat.start_wasm()
                st.extend(res)
                if tail:
                    # host tail call: return results directly
                    n = len(res)
                    results = st[len(st) - n:] if n else []
                    del st[fp:]
                    st.extend(results)
                    ret_pc, prev_fp, prev_opbase, prev_module = frames.pop()
                    if len(frames) == base_frames:
                        out = st[len(st) - n:] if n else []
                        del st[len(st) - n:]
                        return out
                    pc, fp, opbase = ret_pc, prev_fp, prev_opbase
                    if prev_module is not None and prev_module is not module:
                        module = prev_module
                        image = module.lowered
                        ops, aa, bb, cc, imm = image.op, image.a, image.b, image.c, image.imm
                        brt = image.br_table
                        v128c = image.v128
                        funcs, memories = module.funcs, module.memories
                        globals_, tables = module.globals, module.tables
                        elems, datas = module.elems, module.datas
                else:
                    pc += 1
            else:
                cmeta = callee.module.lowered.funcs[callee.func_idx]
                nargs = cmeta.nparams
                if tail:
                    # Replace current frame (reference: stackmgr.h:80-98).
                    tail_args = st[len(st) - nargs:] if nargs else []
                    del st[fp:]
                    st.extend(tail_args)
                    ret_frame = frames.pop()
                else:
                    ret_frame = (pc + 1, fp, opbase, module)
                if len(frames) - base_frames >= thread.max_call_depth:
                    trap(ErrCode.CallStackExhausted)
                frames.append(ret_frame)
                fp = len(st) - nargs
                st.extend([0] * (cmeta.nlocals - nargs))
                opbase = fp + cmeta.nlocals
                if callee.module is not module:
                    module = callee.module
                    image = module.lowered
                    ops, aa, bb, cc, imm = image.op, image.a, image.b, image.c, image.imm
                    brt = image.br_table
                    v128c = image.v128
                    funcs, memories = module.funcs, module.memories
                    globals_, tables = module.globals, module.tables
                    elems, datas = module.elems, module.datas
                pc = cmeta.entry_pc
        elif op == Op.drop:
            st.pop()
            pc += 1
        elif op == Op.select:
            c = st.pop()
            v2 = st.pop()
            if c == 0:
                st[-1] = v2
            pc += 1
        elif op == Op.global_get:
            st.append(globals_[aa[pc]].value)
            pc += 1
        elif op == Op.global_set:
            globals_[aa[pc]].value = st.pop()
            pc += 1
        elif op in _LOAD_INFO:
            nbytes, signed, mask = _LOAD_INFO[op]
            addr = (st[-1] & MASK32) + (imm[pc] & MASK64)
            st[-1] = memories[0].load(addr, nbytes, signed) & mask
            pc += 1
        elif op in _STORE_INFO:
            nbytes = _STORE_INFO[op]
            v = st.pop()
            addr = (st.pop() & MASK32) + (imm[pc] & MASK64)
            memories[0].store(addr, nbytes, v)
            pc += 1
        elif op == Op.memory_size:
            st.append(memories[0].pages)
            pc += 1
        elif op == Op.memory_grow:
            delta = st.pop() & MASK32
            st.append(memories[0].grow(delta) & MASK32)
            pc += 1
        elif op == Op.memory_init:
            n = st.pop() & MASK32
            src = st.pop() & MASK32
            dst = st.pop() & MASK32
            seg = datas[aa[pc]]
            if src + n > len(seg.data):
                trap(ErrCode.MemoryOutOfBounds)
            memories[0].store_bytes(dst, seg.data[src:src + n])
            pc += 1
        elif op == Op.data_drop:
            datas[aa[pc]].clear()
            pc += 1
        elif op == Op.memory_copy:
            n = st.pop() & MASK32
            src = st.pop() & MASK32
            dst = st.pop() & MASK32
            buf = memories[0].load_bytes(src, n)
            memories[0].store_bytes(dst, buf)
            pc += 1
        elif op == Op.memory_fill:
            n = st.pop() & MASK32
            val = st.pop() & 0xFF
            dst = st.pop() & MASK32
            memories[0].check_bounds(dst, n)  # trap before allocating n bytes
            memories[0].store_bytes(dst, bytes([val]) * n)
            pc += 1
        elif op == Op.unreachable:
            trap(ErrCode.Unreachable)
        elif op == Op.ref_null:
            st.append(0)
            pc += 1
        elif op == Op.ref_is_null:
            st[-1] = 1 if st[-1] == 0 else 0
            pc += 1
        elif op == Op.ref_func:
            st.append(thread.store.intern_ref(funcs[aa[pc]]))
            pc += 1
        elif op == Op.table_get:
            i = st[-1] & MASK32
            st[-1] = tables[aa[pc]].get(i)
            pc += 1
        elif op == Op.table_set:
            v = st.pop()
            i = st.pop() & MASK32
            tables[aa[pc]].set(i, v)
            pc += 1
        elif op == Op.table_size:
            st.append(tables[aa[pc]].size)
            pc += 1
        elif op == Op.table_grow:
            delta = st.pop() & MASK32
            init = st.pop()
            st.append(tables[aa[pc]].grow(delta, init) & MASK32)
            pc += 1
        elif op == Op.table_fill:
            n = st.pop() & MASK32
            val = st.pop()
            i = st.pop() & MASK32
            tab = tables[aa[pc]]
            if i + n > tab.size:
                trap(ErrCode.TableOutOfBounds)
            for k in range(n):
                tab.refs[i + k] = val
            pc += 1
        elif op == Op.table_copy:
            n = st.pop() & MASK32
            src = st.pop() & MASK32
            dst = st.pop() & MASK32
            tdst, tsrc = tables[aa[pc]], tables[bb[pc]]
            if src + n > tsrc.size or dst + n > tdst.size:
                trap(ErrCode.TableOutOfBounds)
            chunk = tsrc.refs[src:src + n]
            tdst.refs[dst:dst + n] = chunk
            pc += 1
        elif op == Op.table_init:
            n = st.pop() & MASK32
            src = st.pop() & MASK32
            dst = st.pop() & MASK32
            seg = elems[aa[pc]]
            tab = tables[bb[pc]]
            if src + n > len(seg.refs) or dst + n > tab.size:
                trap(ErrCode.TableOutOfBounds)
            tab.refs[dst:dst + n] = seg.refs[src:src + n]
            pc += 1
        elif op == Op.elem_drop:
            elems[aa[pc]].clear()
            pc += 1
        elif op == Op.v128_const:
            st.append(v128c[aa[pc]])
            pc += 1
        elif op == Op.i8x16_shuffle:
            b = st.pop()
            st[-1] = _simd.shuffle(st[-1], b, v128c[aa[pc]])
            pc += 1
        elif op in _SIMD_EXTRACT:
            shape, signed, mask = _SIMD_EXTRACT[op]
            st[-1] = _simd.extract_lane(st[-1], shape, aa[pc], signed) & mask
            pc += 1
        elif op in _SIMD_REPLACE:
            x = st.pop()
            st[-1] = _simd.replace_lane(st[-1], _SIMD_REPLACE[op], aa[pc], x)
            pc += 1
        elif op == Op.v128_load:
            addr = (st[-1] & MASK32) + (imm[pc] & MASK64)
            st[-1] = memories[0].load(addr, 16, False)
            pc += 1
        elif op == Op.v128_store:
            v = st.pop()
            addr = (st.pop() & MASK32) + (imm[pc] & MASK64)
            memories[0].store(addr, 16, v & MASK128)
            pc += 1
        elif op in _SIMD_EXT_LOAD:
            wbytes, nl, signed = _SIMD_EXT_LOAD[op]
            addr = (st[-1] & MASK32) + (imm[pc] & MASK64)
            raw = memories[0].load_bytes(addr, wbytes * nl)
            vals = [int.from_bytes(raw[k * wbytes:(k + 1) * wbytes],
                                   "little", signed=signed)
                    for k in range(nl)]
            st[-1] = _simd.pack(vals, (16 // nl) * 8)
            pc += 1
        elif op in _SIMD_SPLAT_LOAD:
            wbytes = _SIMD_SPLAT_LOAD[op]
            addr = (st[-1] & MASK32) + (imm[pc] & MASK64)
            x = memories[0].load(addr, wbytes, False)
            st[-1] = _simd.pack([x] * (16 // wbytes), wbytes * 8)
            pc += 1
        elif op in _SIMD_ZERO_LOAD:
            wbytes = _SIMD_ZERO_LOAD[op]
            addr = (st[-1] & MASK32) + (imm[pc] & MASK64)
            st[-1] = memories[0].load(addr, wbytes, False)
            pc += 1
        elif op in _SIMD_LANE_LOAD:
            wbytes = _SIMD_LANE_LOAD[op]
            v = st.pop()
            addr = (st.pop() & MASK32) + (imm[pc] & MASK64)
            x = memories[0].load(addr, wbytes, False)
            shape = {1: "i8x16", 2: "i16x8", 4: "i32x4", 8: "i64x2"}[wbytes]
            st.append(_simd.replace_lane(v, shape, aa[pc], x))
            pc += 1
        elif op in _SIMD_LANE_STORE:
            wbytes = _SIMD_LANE_STORE[op]
            v = st.pop()
            addr = (st.pop() & MASK32) + (imm[pc] & MASK64)
            shape = {1: "i8x16", 2: "i16x8", 4: "i32x4", 8: "i64x2"}[wbytes]
            memories[0].store(addr, wbytes,
                              _simd.extract_lane(v, shape, aa[pc], False))
            pc += 1
        elif op == Op.nop:
            pc += 1
        else:
            raise TrapError(ErrCode.ExecutionFailed,
                            f"scalar engine: unhandled lowered op {op} at pc {pc}")
