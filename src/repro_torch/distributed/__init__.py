"""Tensor-parallel serving over ``torch.distributed`` (a port of
``repro/distributed``): the sharding rules (``sharding.py``), the
collectives by mesh axis (``collectives.py``), the sharded serving
surface and the process spawner (``tp.py``) and the rank-side entry
points of spawned runs (``runs.py``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    Mesh,
    ShardingPlan,
    make_plan,
)
