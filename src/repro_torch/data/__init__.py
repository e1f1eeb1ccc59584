"""Procedural data of the port (a numpy-only copy of ``repro/data``)."""
from repro_torch.data.taskgen import (CATEGORIES, TaskSet,  # noqa: F401
                                      make_taskset)
