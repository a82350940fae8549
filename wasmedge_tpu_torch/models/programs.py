"""Benchmark/workload module builders."""

from __future__ import annotations

import numpy as np

from wasmedge_tpu_torch.utils.builder import ModuleBuilder


def build_fib() -> bytes:
    """Recursive fib(n) — BASELINE config 1: i32 numeric + call/br only."""
    b = ModuleBuilder()
    b.add_function(["i32"], ["i32"], [], [
        ("local.get", 0), ("i32.const", 2), "i32.lt_s",
        ("if", "i32"),
        ("local.get", 0),
        "else",
        ("local.get", 0), ("i32.const", 1), "i32.sub", ("call", 0),
        ("local.get", 0), ("i32.const", 2), "i32.sub", ("call", 0),
        "i32.add",
        "end",
    ], export="fib")
    return b.build()


def build_fac() -> bytes:
    """Recursive factorial over i64 (reference example: fac(12))."""
    b = ModuleBuilder()
    b.add_function(["i64"], ["i64"], [], [
        ("local.get", 0), ("i64.const", 1), "i64.le_s",
        ("if", "i64"),
        ("i64.const", 1),
        "else",
        ("local.get", 0),
        ("local.get", 0), ("i64.const", 1), "i64.sub", ("call", 0),
        "i64.mul",
        "end",
    ], export="fac")
    return b.build()


def build_loop_sum() -> bytes:
    """sum(0..n) via a loop — pure-branch workload, no calls."""
    b = ModuleBuilder()
    b.add_function(["i32"], ["i32"], ["i32", "i32"], [
        ("block", None),
        ("loop", None),
        ("local.get", 1), ("local.get", 0), "i32.ge_u", ("br_if", 1),
        ("local.get", 2), ("local.get", 1), "i32.add", ("local.set", 2),
        ("local.get", 1), ("i32.const", 1), "i32.add", ("local.set", 1),
        ("br", 0),
        "end",
        "end",
        ("local.get", 2),
    ], export="loop_sum")
    return b.build()


def build_memory_workload(passes: int = 1) -> bytes:
    """Write-then-checksum over linear memory (config 2 memory traffic).

    `passes` repeats the whole write+checksum cycle (same load/store mix,
    more work per invocation) so benchmarks can amortize fixed host-link
    round trips over enough device work to measure the engine rather
    than the link."""
    b = ModuleBuilder()
    b.add_memory(1, 16)
    # locals: 0=n (param), 1=i, 2=acc, 3=pass counter
    b.add_function(["i32"], ["i32"], ["i32", "i32", "i32"], [
        ("i32.const", passes), ("local.set", 3),
        ("block", None),
        ("loop", None),
        # store n words of i*2654435761
        ("i32.const", 0), ("local.set", 1),
        ("block", None),
        ("loop", None),
        ("local.get", 1), ("local.get", 0), "i32.ge_u", ("br_if", 1),
        ("local.get", 1), ("i32.const", 4), "i32.mul",
        ("local.get", 1), ("i32.const", 0x9E3779B1 - 2**32), "i32.mul",
        ("local.get", 3), ("i32.const", 1), "i32.sub", "i32.xor",
        ("i32.store", 2, 0),
        ("local.get", 1), ("i32.const", 1), "i32.add", ("local.set", 1),
        ("br", 0),
        "end",
        "end",
        # xor-reduce them back
        ("i32.const", 0), ("local.set", 1),
        ("block", None),
        ("loop", None),
        ("local.get", 1), ("local.get", 0), "i32.ge_u", ("br_if", 1),
        ("local.get", 2),
        ("local.get", 1), ("i32.const", 4), "i32.mul", ("i32.load", 2, 0),
        "i32.xor", ("local.set", 2),
        ("local.get", 1), ("i32.const", 1), "i32.add", ("local.set", 1),
        ("br", 0),
        "end",
        "end",
        ("local.get", 3), ("i32.const", 1), "i32.sub", ("local.tee", 3),
        "i32.eqz", ("br_if", 1),
        ("br", 0),
        "end",
        "end",
        ("local.get", 2),
    ], export="mem_checksum")
    return b.build()


def build_coremark_kernel() -> bytes:
    """CoreMark-flavored kernel: list-free core mix of matrix-multiply-ish
    integer MACs, state-machine branches, and CRC over linear memory.
    Not the full CoreMark (no libc), but the same op mix — the config-2
    stand-in until a wasm32 CoreMark binary is available offline."""
    b = ModuleBuilder()
    b.add_memory(1, 16)

    # crc16 step: crc = (crc >> 1) ^ (0xA001 if (crc^bit)&1 else 0)
    crc8 = b.add_function(["i32", "i32"], ["i32"], ["i32"], [
        # for 8 bits
        ("block", None),
        ("loop", None),
        ("local.get", 2), ("i32.const", 8), "i32.ge_u", ("br_if", 1),
        ("local.get", 1), ("local.get", 0), "i32.xor", ("i32.const", 1), "i32.and",
        ("if", None),
        ("local.get", 1), ("i32.const", 1), "i32.shr_u",
        ("i32.const", 0xA001), "i32.xor", ("local.set", 1),
        "else",
        ("local.get", 1), ("i32.const", 1), "i32.shr_u", ("local.set", 1),
        "end",
        ("local.get", 0), ("i32.const", 1), "i32.shr_u", ("local.set", 0),
        ("local.get", 2), ("i32.const", 1), "i32.add", ("local.set", 2),
        ("br", 0),
        "end",
        "end",
        ("local.get", 1),
    ])

    # matrix-ish MAC over memory words + state machine + crc
    b.add_function(["i32"], ["i32"], ["i32", "i32", "i32", "i32"], [
        # locals: 0=n 1=i 2=acc 3=state 4=crc
        ("i32.const", 0xFFFF), ("local.set", 4),
        ("block", None),
        ("loop", None),
        ("local.get", 1), ("local.get", 0), "i32.ge_u", ("br_if", 1),
        # acc += (i*3) * (i+7)  (MAC)
        ("local.get", 2),
        ("local.get", 1), ("i32.const", 3), "i32.mul",
        ("local.get", 1), ("i32.const", 7), "i32.add",
        "i32.mul", "i32.add", ("local.set", 2),
        ("local.get", 1), ("i32.const", 1), "i32.add", ("local.set", 1),
        # state-machine dispatch on acc low bits: all arms continue the loop
        ("local.get", 2), ("i32.const", 7), "i32.and",
        ("br_table", [0, 0, 0], 0),
        "end",
        "end",
        # store acc, crc it
        ("i32.const", 0), ("local.get", 2), ("i32.store", 2, 0),
        ("local.get", 2), ("i32.const", 0xFF), "i32.and",
        ("local.get", 4), ("call", crc8), ("local.set", 4),
        ("local.get", 4), ("local.get", 2), "i32.xor",
    ], export="coremark")
    return b.build()


_WASI = "wasi_snapshot_preview1"
ECHO_MESSAGE = b"hello wasi echo\n"


def build_echo() -> bytes:
    """BASELINE config 4 (bench_echo.py): echo(iters) writes a 16-byte
    message to stdout with WASI fd_write twice per iteration, interleaved
    with compute, and returns the last errno."""
    b = ModuleBuilder()
    b.import_func(_WASI, "fd_write", ["i32", "i32", "i32", "i32"], ["i32"])
    b.add_memory(1, 1)
    # iovec at 64 -> the message at 128 (16 bytes)
    body = [
        ("i32.const", 64), ("i32.const", 128), ("i32.store", 2, 0),
        ("i32.const", 68), ("i32.const", 16), ("i32.store", 2, 0),
    ]
    for i, ch in enumerate(ECHO_MESSAGE):
        body += [("i32.const", 128 + i), ("i32.const", ch),
                 ("i32.store8", 0, 0)]
    body += [
        ("block", None), ("loop", None),
        ("local.get", 1), ("local.get", 0), "i32.ge_u", ("br_if", 1),
        ("i32.const", 1), ("i32.const", 64), ("i32.const", 1),
        ("i32.const", 32), ("call", 0), ("local.set", 2),
        ("i32.const", 1), ("i32.const", 64), ("i32.const", 1),
        ("i32.const", 32), ("call", 0), ("local.set", 2),
        ("local.get", 1), ("i32.const", 1), "i32.add", ("local.set", 1),
        ("br", 0), "end", "end",
        ("local.get", 2),
    ]
    b.add_function(["i32"], ["i32"], ["i32", "i32"], body, export="echo")
    return b.build()


def build_wasi_hello() -> bytes:
    """A WASI program's life: hello(code) reads its arguments
    (args_sizes_get, args_get), writes "hello " + the argument buffer
    (NULs and all, but the last) + the digit code + "\\n" to stdout with
    one fd_write of three iovecs, and ends with proc_exit(code)."""
    b = ModuleBuilder()
    sizes = b.import_func(_WASI, "args_sizes_get", ["i32", "i32"], ["i32"])
    args = b.import_func(_WASI, "args_get", ["i32", "i32"], ["i32"])
    write = b.import_func(_WASI, "fd_write", ["i32", "i32", "i32", "i32"],
                          ["i32"])
    exit_ = b.import_func(_WASI, "proc_exit", ["i32"], [])
    b.add_memory(1, 1)
    b.add_active_data(0, [("i32.const", 128)], b"hello ")

    def store(addr, value_instrs):
        return [("i32.const", addr)] + value_instrs + [("i32.store", 2, 0)]

    body = [
        ("i32.const", 0), ("i32.const", 4), ("call", sizes), "drop",
        ("i32.const", 16), ("i32.const", 256), ("call", args), "drop",
    ]
    # iovecs at 64: {128, 6} "hello ", {256, argv_buf_size - 1}, {140, 2}
    body += store(64, [("i32.const", 128)]) + store(68, [("i32.const", 6)])
    body += store(72, [("i32.const", 256)])
    body += store(76, [("i32.const", 4), ("i32.load", 2, 0),
                       ("i32.const", 1), "i32.sub"])
    body += store(80, [("i32.const", 140)]) + store(84, [("i32.const", 2)])
    body += [("i32.const", 140), ("local.get", 0), ("i32.const", 48),
             "i32.add", ("i32.store8", 0, 0),
             ("i32.const", 141), ("i32.const", 10), ("i32.store8", 0, 0),
             ("i32.const", 1), ("i32.const", 64), ("i32.const", 3),
             ("i32.const", 32), ("call", write), "drop",
             ("local.get", 0), ("call", exit_)]
    b.add_function(["i32"], [], [], body, export="hello")
    return b.build()


def wasi_hello_output(argv, code: int) -> bytes:
    """What one lane of build_wasi_hello writes for WASI args `argv`
    (program name first) and exit code `code` (0..9)."""
    buf = b"".join(a.encode() + b"\0" for a in argv)
    return b"hello " + buf[:-1] + bytes([48 + code, 10])


# Full-size bulk workload: fills of at least 32 KiB and copies of at least
# 16 KiB per iteration; the final fold covers every byte they can touch
# (offsets up to 1024, fills up to BULK_FILL_BYTES + 15 bytes).
BULK_FILL_BYTES = 32768
BULK_COPY_BYTES = 16384
BULK_FOLD_WORDS = 8452


def build_bulk_workload(fill_bytes: int = BULK_FILL_BYTES,
                        copy_bytes: int = BULK_COPY_BYTES,
                        fold_words: int = BULK_FOLD_WORDS) -> bytes:
    """bulk(seed, iters): each iteration fills at least `fill_bytes` at a
    lane-dependent unaligned offset, fills a second overlapping range with
    another byte, copies at least `copy_bytes` overlapping forward
    (dst > src), then overlapping backward (dst < src), and folds two
    loads into a checksum; a last pass folds the first `fold_words` words
    of memory.  One 64 KiB page; `bulk_workload_model` is its Python
    model."""
    b = ModuleBuilder()
    b.add_memory(1, 1)
    F, C = fill_bytes, copy_bytes

    def seed_and(m):
        return [("local.get", 0), ("i32.const", m), "i32.and"]

    off = [("local.get", 4)]
    body = [
        ("block", None), ("loop", None),
        ("local.get", 2), ("local.get", 1), "i32.ge_u", ("br_if", 1),
        # off = ((seed * 7 + i * 13) & 1023) + 1
        ("local.get", 0), ("i32.const", 7), "i32.mul",
        ("local.get", 2), ("i32.const", 13), "i32.mul", "i32.add",
        ("i32.const", 1023), "i32.and", ("i32.const", 1), "i32.add",
        ("local.set", 4),
        # fill(off, seed + i, F + (seed & 15))
        *off, ("local.get", 0), ("local.get", 2), "i32.add",
        ("i32.const", F), *seed_and(15), "i32.add", "memory.fill",
        # fill(off + 100 + (seed & 3), seed * 3 + i, F / 4)
        *off, ("i32.const", 100), "i32.add", *seed_and(3), "i32.add",
        ("local.get", 0), ("i32.const", 3), "i32.mul", ("local.get", 2),
        "i32.add", ("i32.const", F // 4), "memory.fill",
        # copy(off + 5 + (i & 3), off, C + (seed & 7)): forward overlap
        *off, ("i32.const", 5), "i32.add", ("local.get", 2),
        ("i32.const", 3), "i32.and", "i32.add",
        *off, ("i32.const", C), *seed_and(7), "i32.add", "memory.copy",
        # copy(off + 1, off + 7 + (seed & 1), C): backward overlap
        *off, ("i32.const", 1), "i32.add",
        *off, ("i32.const", 7), "i32.add", *seed_and(1), "i32.add",
        ("i32.const", C), "memory.copy",
        # acc = acc * 31 + (load32(off + 8) ^ load8_u(off + C))
        ("local.get", 3), ("i32.const", 31), "i32.mul",
        *off, ("i32.load", 0, 8), *off, ("i32.load8_u", 0, C), "i32.xor",
        "i32.add", ("local.set", 3),
        ("local.get", 2), ("i32.const", 1), "i32.add", ("local.set", 2),
        ("br", 0), "end", "end",
        # acc = acc * 31 + load32(4k) for k < fold_words
        ("block", None), ("loop", None),
        ("local.get", 5), ("i32.const", fold_words), "i32.ge_u", ("br_if", 1),
        ("local.get", 3), ("i32.const", 31), "i32.mul",
        ("local.get", 5), ("i32.const", 4), "i32.mul", ("i32.load", 2, 0),
        "i32.add", ("local.set", 3),
        ("local.get", 5), ("i32.const", 1), "i32.add", ("local.set", 5),
        ("br", 0), "end", "end",
        ("local.get", 3),
    ]
    # locals: 0 seed, 1 iters (params); 2 i, 3 acc, 4 off, 5 k
    b.add_function(["i32", "i32"], ["i32"], ["i32"] * 4, body, export="bulk")
    return b.build()


def bulk_workload_model(seeds, iters: int, fill_bytes: int = BULK_FILL_BYTES,
                        copy_bytes: int = BULK_COPY_BYTES,
                        fold_words: int = BULK_FOLD_WORDS):
    """build_bulk_workload's bulk(seed, iters) for each seed, one
    bytearray page per lane: the checksums it returns ([lanes] uint32)
    and the pages it leaves ([lanes, 65536] uint8)."""
    M = 0xFFFFFFFF
    F, C = fill_bytes, copy_bytes
    seeds = np.atleast_1d(np.asarray(seeds, np.int64)) & M
    pages = np.zeros((seeds.size, 65536), np.uint8)
    accs = np.zeros(seeds.size, np.uint64)
    for j, seed in enumerate(seeds.tolist()):
        m = bytearray(65536)
        acc = 0
        for i in range(iters):
            off = ((seed * 7 + i * 13) & 1023) + 1
            n = F + (seed & 15)
            m[off:off + n] = bytes([(seed + i) & 0xFF]) * n
            d, n = off + 100 + (seed & 3), F // 4
            m[d:d + n] = bytes([(seed * 3 + i) & 0xFF]) * n
            d, n = off + 5 + (i & 3), C + (seed & 7)
            m[d:d + n] = m[off:off + n]  # the right side is read first
            d, s = off + 1, off + 7 + (seed & 1)
            m[d:d + C] = m[s:s + C]
            word = int.from_bytes(m[off + 8:off + 12], "little")
            acc = (acc * 31 + (word ^ m[off + C])) & M
        accs[j] = acc
        pages[j] = np.frombuffer(bytes(m), np.uint8)
    words = pages[:, :4 * fold_words].view("<u4").astype(np.uint64)
    for k in range(fold_words):
        accs = (accs * np.uint64(31) + words[:, k]) & np.uint64(M)
    return accs.astype(np.uint32), pages


# BASELINE config 3's workload (bench_simd.py): an i32x4 multiply-add and
# splat loop with a byte shuffle, then an unaligned v128 store and load.
SIMD_LOOP_WAT = """
(module
  (memory 1)
  (func (export "vloop") (param i32) (result i32)
    (local $acc v128)
    (local $mul v128)
    (local $i i32)
    (local.set $acc (v128.const i32x4 1 2 3 4))
    (local.set $mul (v128.const i32x4 3 5 7 11))
    (block (loop
      (br_if 1 (i32.ge_u (local.get $i) (local.get 0)))
      (local.set $acc
        (i32x4.add
          (i32x4.mul (local.get $acc) (local.get $mul))
          (i32x4.splat (local.get $i))))
      (local.set $acc
        (v128.xor (local.get $acc)
                  (i8x16.shuffle 4 5 6 7 0 1 2 3 12 13 14 15 8 9 10 11
                                 (local.get $acc) (local.get $acc))))
      (local.set $i (i32.add (local.get $i) (i32.const 1)))
      (br 0)))
    (v128.store offset=5 (i32.const 32) (local.get $acc))
    (local.set $acc (v128.load offset=5 (i32.const 32)))
    (i32.add
      (i32x4.extract_lane 0 (local.get $acc))
      (i32.add (i32x4.extract_lane 1 (local.get $acc))
               (i32.add (i32x4.extract_lane 2 (local.get $acc))
                        (i32x4.extract_lane 3 (local.get $acc)))))))
"""


def build_simd_loop() -> bytes:
    """vloop(n) of bench_simd.py: BASELINE config 3, v128 lane math."""
    from wasmedge_tpu_torch.utils.wat import parse_wat

    return parse_wat(SIMD_LOOP_WAT)


def simd_loop_model(n: int) -> int:
    """What vloop(n) returns (an i32, as its unsigned value)."""
    M = 0xFFFFFFFF
    a0, a1, a2, a3 = 1, 2, 3, 4
    for i in range(n):
        a0, a1 = (a0 * 3 + i) & M, (a1 * 5 + i) & M
        a2, a3 = (a2 * 7 + i) & M, (a3 * 11 + i) & M
        # the shuffle swaps the words of each pair: acc ^= that
        a0 = a1 = a0 ^ a1
        a2 = a3 = a2 ^ a3
    return (a0 + a1 + a2 + a3) & M
