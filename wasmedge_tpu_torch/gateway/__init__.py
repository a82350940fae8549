"""Network-facing multi-tenant serving gateway.

The front door of the batch runtime: a stdlib HTTP server
(gateway/http.py) over generation-swapped BatchServers on the card
(gateway/service.py), with runtime guest-module registration through the
loader -> validator -> image pipeline (gateway/registry.py), per-tenant
auth, rate, quota and weight at the edge (gateway/tenants.py),
crash / restart durability over an on-disk module store and async-request
journal (gateway/durable.py), and truthful health with degraded-mode load
shedding (gateway/health.py).  A copy of `wasmedge_tpu/gateway/` without
fleet federation and autoscaling (ROADMAP A7.9).

    from wasmedge_tpu_torch.gateway import Gateway, GatewayService

    svc = GatewayService(lanes=4096, state_dir="/var/lib/wasmedge-gw")
    svc.register_module("fib", wasm_bytes=data)
    gw = Gateway(svc, port=8080).start()
    # POST /v1/invoke {"module": "fib", "func": "fib", "args": [30]}
    # ... crash ...
    svc = GatewayService(lanes=4096, state_dir="/var/lib/wasmedge-gw",
                         resume=True)   # modules and 202 ids come back

`GatewayService(device="cpu")` runs on the plain interpreter (the tests
do); the default is the card, and without one the service raises.
"""

from wasmedge_tpu_torch.gateway.durable import (  # noqa: F401
    DurabilityError,
    DurableStore,
)
from wasmedge_tpu_torch.gateway.health import (  # noqa: F401
    HealthGate,
    ShedLoad,
    health_of,
)
from wasmedge_tpu_torch.gateway.http import Gateway  # noqa: F401
from wasmedge_tpu_torch.gateway.registry import ModuleRegistry  # noqa: F401
from wasmedge_tpu_torch.gateway.service import (  # noqa: F401
    GatewayClosed,
    GatewayRequest,
    GatewayService,
    GenerationBuildFailed,
)
from wasmedge_tpu_torch.gateway.tenants import (  # noqa: F401
    AuthError,
    GatewayTenants,
    RateLimited,
    TenantPolicy,
)
