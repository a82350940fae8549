"""Truthful gateway health + degraded-mode load shedding (r13).

The r11 `/healthz` was a static liveness stub: a dead BatchServer
serving thread, a failed generation swap, or a gateway that could no
longer persist a checkpoint all still answered `200 {"ok": true}`.
This module computes the real thing — a machine-readable report over
the signals that actually predict whether the NEXT request will be
served:

  driver       the current generation's serving thread is alive and
               the server has not terminally failed       (unhealthy)
  generation   a serving generation exists at all          (degraded —
               the gateway can still register modules)
  last_swap    the most recent generation build/swap
               succeeded (a rollback leaves the PRIOR
               generation serving: degraded, not dead)     (degraded)
  queue        queued depth / capacity below the
               saturation ratio                            (degraded)
  checkpoint   the serving state's last snapshot write
               succeeded (a server that cannot persist
               cannot promise crash recovery)              (degraded)
  journal      the durable manifest/journal writes are
               succeeding (durability-enabled gateways)    (degraded)

`status` is the worst level across checks: "healthy" -> HTTP 200,
"degraded" -> HTTP 200 with the failing checks in the body (load
balancers keep routing, operators see why), "unhealthy" -> HTTP 503.

Degraded gateways optionally SHED: rather than admitting everyone into
a queue that will time them all out, submissions from the lowest-weight
tenant tier are rejected up front with a retryable 429 (ShedLoad), so
paying traffic keeps its latency and shed clients get a machine-
readable "come back later" instead of a 504 after the wait.

A copy of `wasmedge_tpu/gateway/health.py` without the checks of
subsystems the port does not have yet: the lane virtualizer's headroom
on the queue check (ROADMAP A7.3), and the fleet and churn checks
(A7.9).
"""

from __future__ import annotations

import time
from typing import Optional

from wasmedge_tpu_torch.common.errors import ErrCode, WasmError

# queued/capacity ratio beyond which the queue check degrades (and
# shedding, when enabled, kicks in)
QUEUE_SATURATION_RATIO = 0.8

_LEVELS = {"healthy": 0, "degraded": 1, "unhealthy": 2}


class ShedLoad(WasmError):
    """Degraded-mode load shedding rejected this submission at the
    edge.  Retryable — the same request is welcome once the gateway
    recovers (HTTP 429 + Retry-After, like backpressure, but carrying
    the `shed` detail so clients can tell policy from pressure)."""

    retryable = True
    detail = "shed"

    def __init__(self, tenant: str, reason: str):
        super().__init__(
            ErrCode.CostLimitExceeded,
            f"tenant {tenant!r} shed while gateway degraded ({reason})")
        self.tenant = tenant
        self.retry_after_s = 1.0


def _check(ok: bool, level: str, detail: str) -> dict:
    return {"ok": bool(ok),
            "level": "healthy" if ok else level,
            "detail": detail}


def health_of(svc) -> dict:
    """One machine-readable health report over a GatewayService.
    Pure read — safe from any thread, including the HTTP pool."""
    checks = {}
    gen = svc.current
    if gen is None:
        checks["generation"] = _check(
            False, "degraded",
            "no serving generation (no modules registered)")
    else:
        srv = gen.server
        if srv.failed is not None:
            checks["driver"] = _check(
                False, "unhealthy",
                f"serving generation {gen.gen_id} terminally failed: "
                f"{srv.failed!r}")
        else:
            t = srv._thread
            dead = t is not None and not t.is_alive() and not srv._stop
            checks["driver"] = _check(
                not dead, "unhealthy",
                f"generation {gen.gen_id} driver thread died"
                if dead else f"generation {gen.gen_id} driver alive")
        cap = max(int(srv.k.queue_capacity), 1)
        depth = len(srv.queue)
        ratio = depth / cap
        saturated = ratio >= QUEUE_SATURATION_RATIO
        detail = f"queue {depth}/{cap} ({ratio:.0%} of capacity)"
        checks["queue"] = _check(not saturated, "degraded", detail)
        streak = int(getattr(srv, "checkpoint_fail_streak", 0))
        checks["checkpoint"] = _check(
            streak == 0, "degraded",
            f"{streak} consecutive serve-checkpoint write failures "
            f"(last: {srv.last_checkpoint_error!r})"
            if streak else "serve checkpoints writing")
    last = svc.last_swap
    if last is not None:
        checks["last_swap"] = _check(
            bool(last.get("ok")), "degraded",
            last.get("error") or f"generation {last.get('generation')} "
                                 f"swap ok")
    if svc.durable is not None:
        bad = int(svc.counters.get("journal_errors", 0))
        streak = int(getattr(svc, "_journal_fail_streak", 0))
        checks["journal"] = _check(
            streak == 0, "degraded",
            f"durable journal writes failing (streak {streak}, "
            f"total {bad})" if streak else "durable journal writing")
    if getattr(svc, "force_degraded", False):
        checks["forced"] = _check(False, "degraded",
                                  "operator forced degraded mode")
    status = "healthy"
    for c in checks.values():
        if _LEVELS[c["level"]] > _LEVELS[status]:
            status = c["level"]
    return {"ok": status != "unhealthy", "status": status,
            "checks": checks}


class HealthGate:
    """Cheap memoized health for the submit hot path: re-evaluates at
    most every `ttl_s`, so a thousand concurrent submits cost one
    health walk, not a thousand."""

    def __init__(self, svc, ttl_s: float = 0.1):
        self.svc = svc
        self.ttl_s = float(ttl_s)
        self._t = -1.0
        self._cached: Optional[dict] = None

    def health(self, fresh: bool = False) -> dict:
        now = time.monotonic()
        if fresh or self._cached is None or now - self._t > self.ttl_s:
            self._cached = health_of(self.svc)
            self._t = now
        return self._cached

    def maybe_shed(self, tenant: str):
        """Raise ShedLoad when the gateway is degraded, shedding is
        enabled, and `tenant` rides the lowest weight tier.  Healthy
        gateways return immediately (one memoized dict read)."""
        if not self.svc.shed_on_degraded:
            return
        h = self.health()
        if h["status"] == "healthy":
            return
        floor = self.svc.tenants.shed_weight_floor()
        if floor is None:
            return   # single tier: shedding would be an outage
        if self.svc.tenants.effective_weight(tenant) <= floor:
            reasons = [c["detail"] for c in h["checks"].values()
                       if not c["ok"]]
            raise ShedLoad(tenant, "; ".join(reasons) or h["status"])
