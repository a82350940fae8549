"""Async execution: detached thread + future, with cancel -> stop token.

Mirrors the reference Async<T> (WasmEdge include/vm/async.h):
one detached thread per async call, a shared future for get/waitFor,
and cancel() wired to the VM's stop() so the running interpreter observes
the interruption token at calls and branches.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, TimeoutError as FutureTimeout
from typing import Callable, Optional


class Async:
    """Future-valued handle over a detached worker thread."""

    def __init__(self, fn: Callable, stop_fn: Optional[Callable] = None):
        self._future: Future = Future()
        self._stop_fn = stop_fn

        def run():
            try:
                self._future.set_result(fn())
            except BaseException as e:  # noqa: BLE001 - relayed via future
                self._future.set_exception(e)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def get(self):
        """Block until the result (or raise the relayed error)."""
        return self._future.result()

    def wait_for(self, seconds: float) -> bool:
        """True if finished within the timeout (async.h:56-63)."""
        try:
            self._future.exception(timeout=seconds)
            return True
        except FutureTimeout:
            return False

    def done(self) -> bool:
        return self._future.done()

    def cancel(self):
        """Request interruption of the running execution (async.h:73-77)."""
        if self._stop_fn is not None:
            self._stop_fn()
