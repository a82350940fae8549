"""Per-tenant gateway policy: auth, rate/quota/weight, registration.

The FairQueue already enforces weighted-DRR admission and in-flight
quotas INSIDE the serving loop; this module is the network-edge half of
tenancy — who a request belongs to (API-key auth stub), how fast it may
arrive (token-bucket rate limiting, checked before the request ever
touches the queue), and whether the tenant may register modules.

Policies load from a JSON or TOML file (`GatewayTenants.from_file`):

    {
      "require_auth": true,
      "default_tenant": "anon",
      "tenants": {
        "alice": {"api_key": "sk-alice", "weight": 2.0, "quota": 8,
                   "rate_per_s": 50, "burst": 100, "can_register": true},
        "bob":   {"api_key": "sk-bob", "weight": 1.0}
      }
    }

`weight` / `quota` map straight onto the FairQueue's DRR weights and
in-flight quotas (serve/queue.py); `rate_per_s`/`burst` gate the HTTP
edge.  Auth is a deliberate STUB — a bearer-token equality check, the
seam where a real deployment plugs mTLS/JWT — but the taxonomy
(AuthError -> 401, RateLimited -> 429 + Retry-After) is final.

A copy of `wasmedge_tpu/gateway/tenants.py` with two keys refused, not
ignored: `analysis` (a tenant's or the file's static-analysis admission
policy, ROADMAP A7.8) and `resident_budget_bytes` (the lane
virtualizer's budget, A7.3), so that a tenants file never means less in
the port than it says.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional


# tenant-file keys of subsystems the port does not have yet, and their
# ROADMAP items: a file that sets one is refused
_NOT_PORTED = {"analysis": "A7.8", "resident_budget_bytes": "A7.3"}


class AuthError(Exception):
    """Missing/unknown API key, or a claimed tenant that does not match
    the key's tenant.  HTTP layer maps to 401."""


class RateLimited(Exception):
    """Token bucket empty: transient, carries the refill hint the HTTP
    layer forwards as Retry-After (429)."""

    def __init__(self, tenant: str, retry_after_s: float):
        super().__init__(f"tenant {tenant!r} rate-limited")
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)


class TokenBucket:
    """Classic token bucket: `rate` tokens/s up to `burst` capacity.
    Monotonic-clock based; thread-safe (one bucket is hit from every
    HTTP handler thread of its tenant)."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0):
        """Take `n` tokens; returns None on success, else the seconds
        until enough tokens will have refilled."""
        with self._lock:
            now = time.monotonic()
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
            self._t = now
            if self.tokens >= n:
                self.tokens -= n
                return None
            if self.rate <= 0:
                return float("inf")
            return (n - self.tokens) / self.rate


@dataclasses.dataclass
class TenantPolicy:
    """One tenant's edge policy (None = unlimited / default)."""

    name: str
    api_key: Optional[str] = None
    weight: float = 1.0
    quota: Optional[int] = None        # max in-flight lanes (FairQueue)
    rate_per_s: Optional[float] = None  # HTTP-edge request rate
    burst: Optional[float] = None       # bucket capacity (default 2*rate)
    can_register: bool = True           # POST /v1/modules allowed

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "TenantPolicy":
        known = {"api_key", "weight", "quota", "rate_per_s", "burst",
                 "can_register"}
        for key, item in _NOT_PORTED.items():
            if d.get(key) is not None:
                raise ValueError(
                    f"tenant {name!r}: {key!r} is not in the port yet "
                    f"(ROADMAP {item})")
        bad = set(d) - known - set(_NOT_PORTED)
        if bad:
            raise ValueError(
                f"tenant {name!r}: unknown policy keys {sorted(bad)}")
        return cls(name=name,
                   api_key=d.get("api_key"),
                   weight=float(d.get("weight", 1.0)),
                   quota=(int(d["quota"]) if d.get("quota") is not None
                          else None),
                   rate_per_s=(float(d["rate_per_s"])
                               if d.get("rate_per_s") is not None
                               else None),
                   burst=(float(d["burst"]) if d.get("burst") is not None
                          else None),
                   can_register=bool(d.get("can_register", True)))


class GatewayTenants:
    """The gateway's tenant table: auth, rate buckets, FairQueue maps.

    With `require_auth=False` and no policies (the default when no
    config file is given) every request is accepted under the tenant
    name it claims — the open configuration the smoke/bench modes and
    single-operator setups use."""

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None,
                 require_auth: bool = False,
                 default_tenant: str = "default"):
        self.policies = dict(policies or {})
        self.require_auth = bool(require_auth)
        self.default_tenant = default_tenant
        self._by_key = {p.api_key: p for p in self.policies.values()
                        if p.api_key}
        self._buckets: Dict[str, TokenBucket] = {}
        for p in self.policies.values():
            if p.rate_per_s is not None:
                self._buckets[p.name] = TokenBucket(
                    p.rate_per_s, p.burst if p.burst is not None
                    else 2.0 * p.rate_per_s)

    # -- config file -------------------------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "GatewayTenants":
        """JSON (default) or TOML (*.toml, stdlib tomllib) tenant file."""
        if str(path).endswith(".toml"):
            import tomllib

            with open(path, "rb") as f:
                doc = tomllib.load(f)
        else:
            import json

            with open(path) as f:
                doc = json.load(f)
        return cls.from_dict(doc)

    @classmethod
    def from_dict(cls, doc: dict) -> "GatewayTenants":
        if doc.get("analysis") is not None:
            raise ValueError(f"'analysis' is not in the port yet (ROADMAP "
                             f"{_NOT_PORTED['analysis']})")
        policies = {name: TenantPolicy.from_dict(name, d)
                    for name, d in (doc.get("tenants") or {}).items()}
        return cls(policies=policies,
                   require_auth=bool(doc.get("require_auth", False)),
                   default_tenant=doc.get("default_tenant", "default"))

    # -- FairQueue bridge --------------------------------------------------
    def weights(self) -> Dict[str, float]:
        return {p.name: p.weight for p in self.policies.values()}

    def quotas(self) -> Dict[str, int]:
        return {p.name: p.quota for p in self.policies.values()
                if p.quota is not None}

    # -- load shedding -----------------------------------------------------
    def effective_weight(self, tenant: str) -> float:
        """The DRR weight a tenant submits under (1.0 when it has no
        policy — the FairQueue default)."""
        p = self.policies.get(tenant)
        return p.weight if p is not None else 1.0

    def shed_weight_floor(self) -> Optional[float]:
        """The weight tier a degraded gateway sheds: the LOWEST
        effective weight across the tiers that can actually submit —
        the configured policies, plus the 1.0 default tier ONLY in an
        open (no-require_auth) configuration where unlisted tenants
        exist.  None when only one tier exists: with every tenant
        equal there is no "lowest" to sacrifice, and shedding everyone
        would turn degradation into an outage (under require_auth, two
        tenants both at weight 0.5 are ONE tier — the phantom 1.0
        default must not make them sheddable)."""
        tiers = {p.weight for p in self.policies.values()}
        if not self.require_auth:
            tiers.add(1.0)   # unlisted tenants ride the default tier
        if len(tiers) < 2:
            return None
        return min(tiers)

    # -- edge checks -------------------------------------------------------
    def authenticate(self, api_key: Optional[str],
                     claimed: Optional[str]) -> str:
        """Resolve the request's tenant.  A presented key must be known
        and wins over (must agree with) any claimed tenant name; with
        require_auth no key is a 401 — and even WITHOUT require_auth, a
        tenant that has an api_key configured can only be claimed by
        presenting it (a keyless claim must not inherit the tenant's
        weight/quota/registration privilege)."""
        if api_key is not None:
            p = self._by_key.get(api_key)
            if p is None:
                raise AuthError("unknown API key")
            if claimed and claimed != p.name:
                raise AuthError(
                    f"API key belongs to tenant {p.name!r}, "
                    f"not {claimed!r}")
            return p.name
        if self.require_auth:
            raise AuthError("missing API key")
        claimed = claimed or self.default_tenant
        p = self.policies.get(claimed)
        if p is not None and p.api_key:
            raise AuthError(
                f"tenant {claimed!r} requires an API key")
        return claimed

    def check_rate(self, tenant: str):
        """Raise RateLimited when the tenant's bucket is empty."""
        b = self._buckets.get(tenant)
        if b is None:
            return
        after = b.try_take()
        if after is not None:
            raise RateLimited(tenant, after)

    def can_register(self, tenant: str) -> bool:
        p = self.policies.get(tenant)
        if p is None:
            # unknown tenants may register only in the open (no-auth,
            # no-policy) configuration
            return not self.require_auth and not self.policies
        return p.can_register
