"""Workloads the port's checks drive, built programmatically (no
wat2wasm): fib (the flagship), fac, loop_sum, mem_checksum, the
CoreMark-style kernel, the WASI echo and hello programs, the
bulk-memory workload and the v128 loop."""

from wasmedge_tpu_torch.models.programs import (
    build_bulk_workload,
    build_coremark_kernel,
    build_echo,
    build_fac,
    build_fib,
    build_loop_sum,
    build_memory_workload,
    build_simd_loop,
    build_wasi_hello,
)

__all__ = [
    "build_fib",
    "build_fac",
    "build_loop_sum",
    "build_memory_workload",
    "build_coremark_kernel",
    "build_echo",
    "build_wasi_hello",
    "build_bulk_workload",
    "build_simd_loop",
]
