"""Public surface of the port's continuum serving stack (the names of
``repro/serving/__init__.py``).

Light names import eagerly; the cluster harness (``Cluster``,
``EngineHandle``, ``SimEngine``, ``EngineBackend``, ``build_continuum``)
pulls in model building, so those resolve lazily via ``__getattr__``.
"""
from repro_torch.serving.engine import (  # noqa: F401
    KVSnapshot,
    Request,
    ServingEngine,
)
from repro_torch.serving.request import (  # noqa: F401
    ContinuumRequest,
    StreamEvent,
)
from repro_torch.serving.router import (  # noqa: F401
    HealthTracker,
    QLMIORouter,
    ServerHandle,
    SimulatedServer,
)
from repro_torch.serving.telemetry import (  # noqa: F401
    MetricsRegistry,
    Telemetry,
    Tracer,
)

_LAZY = ("Cluster", "EngineHandle", "EngineBackend", "SimEngine",
         "build_continuum")

__all__ = ["ServingEngine", "Request", "KVSnapshot",
           "ContinuumRequest", "StreamEvent",
           "HealthTracker", "QLMIORouter", "ServerHandle",
           "SimulatedServer", "Telemetry", "MetricsRegistry", "Tracer",
           *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.serving import cluster
        return getattr(cluster, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
