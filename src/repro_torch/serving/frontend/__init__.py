"""repro_torch.serving.frontend: the network tier over the ensemble
engine.

Four layers, each usable alone:

  - `scheduler.Scheduler.serve_forever` (one module down): the online
    admit/prefill/decode/harvest loop with streaming callbacks and
    mid-decode cancellation;
  - `frontend.router.Router`: N engine replicas behind one least-loaded
    submit() door, with per-replica draining, queue-depth backpressure
    (QueueFull -> HTTP 429), and the zero-downtime drain ->
    swap_params -> rejoin rollout (canary fraction optional);
  - `frontend.server.FrontendServer`: the stdlib HTTP/SSE face
    (POST /v1/generate, GET /metrics, GET /healthz, graceful drain);
  - `frontend.replica`: the same boundary over sockets: each replica
    its own OS process (EngineSpec -> ReplicaProcess) behind a
    crash-latching FleetRouter with retry, elastic scaling, and canary
    rollout over POST /admin/swap.
"""
from repro_torch.serving.frontend.replica import (EngineSpec, FleetRouter,
                                                  ReplicaProcess)
from repro_torch.serving.frontend.router import QueueFull, Replica, Router
from repro_torch.serving.frontend.server import (FrontendServer,
                                                 serve_frontend)

__all__ = ["Replica", "Router", "QueueFull", "FrontendServer",
           "serve_frontend", "EngineSpec", "ReplicaProcess",
           "FleetRouter"]
