"""Request queue of the continuous-batching serving layer.

A copy of `wasmedge_tpu/serve/queue.py` without the seams of the
subsystems the port does not have yet (the fleet's future mirrors, the
gateway's id peek and retry hint); the checkpoint journal's entries
(`asdict`, `from_journal`, `advance_request_ids`) and the recovery
requeue (`push_front`) are here.  One `ServeRequest`
is one device lane's worth of work: an exported function and one
argument tuple, owned by a tenant, optionally with a deadline.
Requests wait in a bounded `FairQueue` (a FIFO per tenant, drained by
weighted deficit round-robin, so a flooding tenant cannot starve a
quota'd one) until the server installs them into freed lanes.

Backpressure is explicit: `push()` beyond `queue_capacity` raises
`QueueSaturated`, never a silent drop; an expired deadline rejects with
`DeadlineExceeded` before the request takes a lane.  `ServeFuture` is
the caller's handle, resolved by the serving loop with the request's
result cells or an error.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from wasmedge_tpu_torch.common.errors import ErrCode, WasmError


class QueueSaturated(WasmError):
    """The bounded request queue is full — backpressure, try later: the
    one retryable rejection of the serving layer (`retryable`)."""

    retryable = True

    def __init__(self, msg: str = "serve queue saturated",
                 retry_after_s: Optional[float] = None):
        super().__init__(ErrCode.CostLimitExceeded, msg)
        # an optional hint of when capacity is expected (the gateway
        # forwards it as HTTP Retry-After)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(WasmError):
    """The request's deadline passed before it completed.  Never
    retryable: the deadline belonged to THIS request; the caller must
    submit a new one if the work still matters."""

    def __init__(self, msg: str = "request deadline exceeded"):
        super().__init__(ErrCode.Terminated, msg)


class ServeRejected(WasmError):
    """The serving LIFECYCLE rejected an accepted request before (or
    instead of) running it — non-drain shutdown, or the stall sweep
    for a request that can never be admitted.  Distinct from a guest
    trap, so that a caller never reads a rejection as "the guest ran and
    trapped"."""

    def __init__(self, msg: str):
        super().__init__(ErrCode.Terminated, msg)


class ServeFuture:
    """Resolution handle for one submitted request.

    Exactly one of `result()` / raised error is the outcome:
      result()  -> list of raw 64-bit result cells (one int per result)
      raises    WasmError — the request's trap (TrapError-shaped code),
                DeadlineExceeded, or the server's terminal failure.
    """

    __slots__ = ("_ev", "_cells", "_error", "request_id", "t_done")

    def __init__(self, request_id: int):
        self._ev = threading.Event()
        self._cells: Optional[List[int]] = None
        self._error: Optional[BaseException] = None
        self.request_id = request_id
        self.t_done: Optional[float] = None   # monotonic resolution stamp

    # -- serving-loop side (first outcome wins) ------------------------------
    def _resolve(self, cells: List[int]):
        if self._ev.is_set():
            return
        self._cells = list(cells)
        self.t_done = time.monotonic()
        self._ev.set()

    def _reject(self, error: BaseException):
        if self._ev.is_set():
            return
        self._error = error
        self.t_done = time.monotonic()
        self._ev.set()

    # -- caller side -------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._ev.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._ev.wait(timeout):
            raise TimeoutError("request not resolved yet")
        if self._error is not None:
            raise self._error
        return list(self._cells)

    @property
    def error(self) -> Optional[BaseException]:
        return self._error if self._ev.is_set() else None


_req_ids = itertools.count(1)
_req_ids_lock = threading.Lock()


def _next_request_id() -> int:
    with _req_ids_lock:
        return next(_req_ids)


def advance_request_ids(past_id: int):
    """Move the process-global request-id counter past `past_id`.

    A cross-process resume adopts journaled requests that keep their
    original (higher) ids; without this, fresh submits in the adopting
    process would restart at 1, inverting the id-ordered crash-recovery
    requeue and eventually duplicating an adopted id in a later
    checkpoint journal."""
    global _req_ids
    with _req_ids_lock:
        nxt = next(_req_ids)
        _req_ids = itertools.count(max(nxt, int(past_id) + 1))


INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1


class ServeRequest:
    """One lane's worth of work (immutable once submitted)."""

    __slots__ = ("id", "func_name", "args", "tenant", "deadline",
                 "t_submit", "future")

    def __init__(self, func_name: str, args: Tuple[int, ...],
                 tenant: str = "default",
                 deadline: Optional[float] = None,
                 t_submit: float = 0.0,
                 request_id: Optional[int] = None):
        self.id = int(request_id) if request_id is not None \
            else _next_request_id()
        self.func_name = func_name
        args = tuple(int(a) for a in args)
        for a in args:
            # lane cells are 64-bit: an unrepresentable arg must be
            # rejected HERE, at submission — np.int64 conversion at
            # admission would raise OverflowError on the SERVING
            # thread and terminally fail the whole generation (every
            # tenant's in-flight work) for one bad request
            if not (INT64_MIN <= a <= INT64_MAX):
                raise ValueError(
                    f"arg {a} does not fit a 64-bit lane cell")
        self.args = args
        self.tenant = tenant
        self.deadline = deadline      # monotonic stamp, None = none
        self.t_submit = t_submit      # monotonic stamp (admission latency)
        self.future = ServeFuture(self.id)

    def asdict(self) -> dict:
        """JSON-serializable journal entry (a checkpoint's binding
        record).  Deadlines are monotonic stamps and futures are
        process-local: neither survives a process, so neither is
        journaled."""
        return {"id": self.id, "func": self.func_name,
                "args": [int(a) for a in self.args],
                "tenant": self.tenant}

    @classmethod
    def from_journal(cls, rec: dict) -> "ServeRequest":
        return cls(rec["func"], tuple(rec["args"]),
                   tenant=rec.get("tenant", "default"),
                   request_id=rec["id"])


class FairQueue:
    """Bounded multi-tenant queue with weighted deficit round-robin pop.

    Each tenant owns a FIFO; `pop()` walks tenants in first-seen order,
    crediting `weight` units of deficit per visit and popping while the
    deficit covers a request — the classic DRR scheduler, deterministic
    for a fixed submission schedule (no clocks, no hashing).  Per-tenant
    `quota` bounds a tenant's *in-flight* lanes: a tenant at quota is
    skipped (its deficit stops accruing too, so it gets no windfall when
    lanes free up)."""

    def __init__(self, capacity: int,
                 weights: Optional[Dict[str, float]] = None,
                 quotas: Optional[Dict[str, int]] = None):
        self.capacity = int(capacity)
        self.weights = dict(weights or {})
        self.quotas = dict(quotas or {})
        self._q: Dict[str, deque] = {}
        self._order: List[str] = []   # tenants, first-seen order
        self._deficit: Dict[str, float] = {}
        self.size = 0
        # tenant -> queued requests carrying a deadline: expire() skips
        # whole tenants at 0, so a flood of no-deadline work is never
        # rescanned every round for one deadlined request elsewhere
        self._deadlined: Dict[str, int] = {}

    def __len__(self) -> int:
        return self.size

    def depth_of(self, tenant: str) -> int:
        q = self._q.get(tenant)
        return len(q) if q else 0

    def push(self, req: ServeRequest):
        if self.size >= self.capacity:
            raise QueueSaturated(
                f"serve queue saturated ({self.size}/{self.capacity})")
        q = self._q.get(req.tenant)
        if q is None:
            q = self._q[req.tenant] = deque()
            self._order.append(req.tenant)
            self._deficit[req.tenant] = 0.0
        q.append(req)
        self.size += 1
        if req.deadline is not None:
            self._deadlined[req.tenant] = \
                self._deadlined.get(req.tenant, 0) + 1

    def push_front(self, reqs: List[ServeRequest]):
        """Re-queue requests at the head of their tenants' FIFOs (crash
        recovery: in-flight work goes back first, in its order).
        Capacity is not enforced: dropping recovered work to
        backpressure would turn a transient fault into data loss."""
        for req in reversed(reqs):
            q = self._q.get(req.tenant)
            if q is None:
                q = self._q[req.tenant] = deque()
                self._order.append(req.tenant)
                self._deficit[req.tenant] = 0.0
            q.appendleft(req)
            self.size += 1
            if req.deadline is not None:
                self._deadlined[req.tenant] = \
                    self._deadlined.get(req.tenant, 0) + 1

    def expire(self, now: float) -> List[ServeRequest]:
        """Remove and return queued requests whose deadline passed.
        O(tenants) when nothing queued carries a deadline, and only
        tenants that do carry one are rescanned — the serving loop
        calls this every round."""
        out = []
        for t in self._order:
            if not self._deadlined.get(t):
                continue
            q = self._q[t]
            keep = deque()
            while q:
                r = q.popleft()
                if r.deadline is not None and now >= r.deadline:
                    out.append(r)
                    self.size -= 1
                    self._deadlined[t] -= 1
                else:
                    keep.append(r)
            self._q[t] = keep
        return out

    def remove_by_id(self, request_id: int) -> Optional[ServeRequest]:
        """Remove one QUEUED (not yet admitted) request by id (the
        server's `withdraw`).  Returns the removed request, or None when the id is
        not queued (already admitted, completed, or never here)."""
        for tenant, q in self._q.items():
            for r in q:
                if r.id == request_id:
                    q.remove(r)
                    self.size -= 1
                    if r.deadline is not None:
                        self._deadlined[tenant] -= 1
                    return r
        return None

    def pop_all(self) -> List[ServeRequest]:
        """Empty the queue unconditionally (the shutdown and failure
        rejection sweep) — quotas and weights do not apply; every queued
        request must get its rejection, not strand behind a quota."""
        out = []
        for t in self._order:
            q = self._q[t]
            out.extend(q)
            q.clear()
        self.size = 0
        self._deadlined.clear()
        return out

    def pop(self, n: int, in_flight: Dict[str, int]) -> List[ServeRequest]:
        """Pop up to `n` requests by weighted deficit round-robin.
        `in_flight` maps tenant -> currently-installed lanes (quota
        accounting; this method treats its own picks as in-flight)."""
        if n <= 0 or self.size == 0:
            return []
        flight = dict(in_flight)
        out: List[ServeRequest] = []
        empty_walks = 0
        while len(out) < n and self.size:
            popped = False
            eligible = False
            for t in self._order:
                if len(out) >= n or not self.size:
                    break
                q = self._q[t]
                if not q:
                    self._deficit[t] = 0.0  # idle tenants bank nothing
                    continue
                quota = self.quotas.get(t)
                if quota is not None and flight.get(t, 0) >= quota:
                    continue
                w = self.weights.get(t, 1.0)
                if w <= 0:
                    continue
                eligible = True
                self._deficit[t] += w
                while q and self._deficit[t] >= 1.0 and len(out) < n:
                    if quota is not None and flight.get(t, 0) >= quota:
                        break
                    r = q.popleft()
                    if r.deadline is not None:
                        self._deadlined[t] -= 1
                    out.append(r)
                    self.size -= 1
                    self._deficit[t] -= 1.0
                    flight[t] = flight.get(t, 0) + 1
                    popped = True
            if not eligible:
                break  # everything queued is quota-blocked (or weight 0)
            if not popped:
                empty_walks += 1
                if empty_walks > 8:
                    # tiny fractional weights would need ~1/w walks to
                    # bank one unit — instead of spinning (or worse,
                    # starving an eligible tenant), force one pop from
                    # the highest-deficit eligible tenant; its deficit
                    # goes negative, which is classic DRR catch-up (the
                    # long-run weight ratio is preserved, nothing with
                    # weight > 0 is ever denied forever)
                    best = max(
                        (t for t in self._order if self._q[t]
                         and self.weights.get(t, 1.0) > 0
                         and not (self.quotas.get(t) is not None
                                  and flight.get(t, 0)
                                  >= self.quotas[t])),
                        key=lambda t: self._deficit[t], default=None)
                    if best is None:
                        break
                    r = self._q[best].popleft()
                    if r.deadline is not None:
                        self._deadlined[best] -= 1
                    out.append(r)
                    self.size -= 1
                    self._deficit[best] -= 1.0
                    flight[best] = flight.get(best, 0) + 1
                    empty_walks = 0
            else:
                empty_walks = 0
        return out
