"""The card's constants for the roofline and the dry run (the counterpart
of ``repro/launch/mesh.py``, whose constants are a TPU v5e chip's).

One NVIDIA H100 SXM, from NVIDIA's H100 Tensor Core GPU datasheet (SXM5
column, dense rates without sparsity, at the 700 W power limit): the
numbers ``PERF.md`` section 6 computes its bounds with.

``make_production_mesh`` and ``make_edge_mesh`` (the JAX module's 16x16
and 2x16x16 TPU meshes, and a 1 x n edge slice) need a
``torch.distributed`` process group over several cards: they come with
tensor parallelism (ROADMAP item 12).  Until then the dry run covers one
card (``MESH = "1xH100"``).
"""
from __future__ import annotations

MESH = "1xH100"

# bf16 tensor-core peak, dense (the datasheet's 1,979 TFLOP/s is with
# 2:4 sparsity)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
# HBM3 bandwidth
HBM_BW = 3.35e12  # B/s
# NVLink 4: 900 GB/s both directions over 18 links, so 450 GB/s each way;
# the counterpart of the JAX module's ICI_BW (one direction)
ICI_BW = 450e9  # B/s
# the card's memory, "80GB" on the datasheet: 80 GiB of HBM3, of which the
# driver reports a little less as usable
# (torch.cuda.get_device_properties(0).total_memory)
HBM_BYTES = 80 * 2 ** 30
