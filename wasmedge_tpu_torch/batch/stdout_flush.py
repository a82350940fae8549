"""Tier 0's stdout flush kernel (`csrc/stdout_flush.cu`): build, bind, launch.

`records(so_buf, so_off, skip)` cuts each lane's buffered fd_write
records out of the [SW, L] stdout plane on the card into one byte stream
per fd, lane after lane, with each lane's first `skip` payload bytes left
out, and returns them with each lane's payload bytes: what the plain
version, `batch/hostcall.py` `_records`, computes on the host from a
download of the plane.  The kernel is built with nvcc at first use into
`_build/` (a plain C interface, bound with ctypes), keyed by the hash of
its source and flags; it launches on the current stream, and the stream
comes down in one copy of exactly the bytes written, into pinned memory.
A failed build or launch raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np
import torch

from wasmedge_tpu_torch.batch import interp

_SRC = os.path.join(interp._CSRC, "stdout_flush.cu")
_META = 4  # csrc/stdout_flush.cu kMeta: fd 1 bytes, fd 2 bytes, lanes, bad
_INT32_MAX = 2**31 - 1

_lib = [None]
_lock = threading.Lock()
# this thread's pinned host buffer and its scratch on the card (by device
# and plane shape)
_local = threading.local()
# the build's "path", "seconds" (0.0 when it was already built) and
# "ptxas" (nvcc's -v output)
BUILD_INFO = {}


def build():
    """Build the flush kernel into `_build/` unless it is there, load it
    and return the library; raises KernelBuildError when nvcc fails or
    the library does not load."""
    with _lock:
        if _lib[0] is not None:
            return _lib[0]
        try:
            return _build()
        except interp.KernelBuildError:
            raise
        except Exception as e:
            raise interp.KernelBuildError(
                f"kernel build failed: {e!r}") from e


def _build():
    """build()'s work, under its lock."""
    flags = interp.NVCC_FLAGS
    key = hashlib.sha256(interp._read(_SRC) + " ".join(flags).encode()) \
        .hexdigest()[:16]
    so = os.path.join(interp._BUILD_DIR, f"libstdout_flush_{key}.so")
    info = {"path": so, "seconds": 0.0, "ptxas": ""}
    if not os.path.exists(so):
        os.makedirs(interp._BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        r = subprocess.run([interp._nvcc(), *flags, "-Xptxas", "-v",
                            "-o", tmp, _SRC],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise interp.KernelBuildError(
                f"nvcc failed ({r.returncode}) on {_SRC}:\n"
                f"{r.stdout}{r.stderr}")
        os.replace(tmp, so)
        info.update(seconds=time.perf_counter() - t0,
                    ptxas=r.stdout + r.stderr)
    lib = ctypes.CDLL(so)
    fn = lib.wasm_stdout_flush
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p] * 4
    BUILD_INFO.update(info)
    _lib[0] = lib
    return lib


def _host_buffer(n: int) -> torch.Tensor:
    """This thread's pinned uint8 buffer of at least n bytes."""
    buf = getattr(_local, "buf", None)
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1 << 16, 2 * (0 if buf is None
                                               else buf.numel())),
                          dtype=torch.uint8, pin_memory=True)
        _local.buf = buf
    return buf


def _scratch(dev, SW: int, L: int) -> tuple:
    """This thread's (meta [4 + L] int32, cnt [2 L] int64, out uint8 of
    4 SW L bytes) on `dev` for a [SW, L] plane, made once."""
    cache = getattr(_local, "scratch", None)
    if cache is None:
        cache = _local.scratch = {}
    key = (str(dev), SW, L)
    if key not in cache:
        cache[key] = (torch.empty(_META + L, dtype=torch.int32, device=dev),
                      torch.empty(2 * L, dtype=torch.int64, device=dev),
                      torch.empty(max(4 * SW * L, 4), dtype=torch.uint8,
                                  device=dev))
    return cache[key]


def launch(so_buf: torch.Tensor, so_off: torch.Tensor, skip: torch.Tensor):
    """Launch the kernel on the current stream: (meta [4 + L] int32, out
    uint8) on the card, as csrc/stdout_flush.cu's entry leaves them
    (nothing is read back; this thread's scratch, valid until its next
    launch on a plane of this shape).  `skip` [L] int32 on the same
    card."""
    dev = so_buf.device
    if dev.type != "cuda":
        raise ValueError(f"the flush kernel runs on the card, not {dev}")
    SW, L = so_buf.shape
    for name, t, shape in (("so_buf", so_buf, (SW, L)),
                           ("so_off", so_off, (L,)), ("skip", skip, (L,))):
        if t.device != dev or t.dtype != torch.int32 or \
                not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected contiguous int32 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    lib = build()
    meta, cnt, out = _scratch(dev, SW, L)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.wasm_stdout_flush(
            so_buf.data_ptr(), so_off.data_ptr(), skip.data_ptr(), SW, L,
            meta.data_ptr(), cnt.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stdout flush kernel launch failed: CUDA error "
                           f"{err}")
    with interp.LAUNCHES_LOCK:
        interp.LAUNCHES["stdout_flush"] += 1
    return meta, out


def records(so_buf: torch.Tensor, so_off: torch.Tensor,
            skip: np.ndarray) -> Optional[tuple]:
    """(fd -> the bytes of its stream, each lane's payload bytes [L]
    int64) of the records in so_buf [SW, L] below each lane's fill
    so_off, with each lane's first skip[lane] payload bytes left out; None
    when no lane has a record.  Both tensors on the card; the streams are
    memoryviews of this thread's pinned buffer, valid until its next
    flush."""
    dev = so_buf.device
    skip = np.asarray(skip, np.int64)
    if skip.any():
        sk = torch.from_numpy(np.clip(skip, 0, _INT32_MAX).astype(np.int32)) \
            .to(dev)
    else:  # no replay to skip (every flush of a run not restored)
        sk = torch.zeros(so_off.shape[0], dtype=torch.int32, device=dev)
    meta, out = launch(so_buf, so_off, sk)
    m = meta.cpu().numpy()
    if m[2] == 0:
        return None
    if m[3] != 0:
        raise RuntimeError(f"stdout flush: {int(m[3])} lanes hold a record "
                           f"past their fill or to an fd other than 1 or 2")
    n1, n2 = int(m[0]), int(m[1])
    host = _host_buffer(n1 + n2)
    if n1 + n2:
        host[:n1 + n2].copy_(out[:n1 + n2])
    view = memoryview(host.numpy())
    per_fd = {fd: view[a:b] for fd, a, b in ((1, 0, n1),
                                             (2, n1, n1 + n2)) if b > a}
    return per_fd, m[_META:].astype(np.int64)
