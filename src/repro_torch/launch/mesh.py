"""The card's constants for the roofline and the dry run (the counterpart
of ``repro/launch/mesh.py``, whose constants are a TPU v5e chip's).

One NVIDIA H100 SXM, from NVIDIA's H100 Tensor Core GPU datasheet (SXM5
column, dense rates without sparsity, at the 700 W power limit): the
numbers ``PERF.md`` section 6 computes its bounds with.

``make_production_mesh`` and ``make_edge_mesh`` are the H100 counterparts
of the JAX module's TPU meshes, as mesh descriptions
(``distributed.sharding.Mesh``: axis names and sizes, no process group)
with the same device counts: 256 cards as (data 32, model 8), the model
axis inside one NVLink node of 8 cards (the JAX module's 16 x 16 v5e pod
keeps its 16-wide model axis on the ICI torus; 8 is the widest all-to-all
NVLink domain of an H100 node); two such pods as (pod 2, data 32, model
8); an edge slice as (data 1, model n).  The dry run reckons each cell's
per-device arguments on them (``dryrun.py --mesh``); the one-card records
keep ``MESH = "1xH100"``.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import Mesh

MESH = "1xH100"
NODE_CARDS = 8  # H100s of one NVLink (NVSwitch) node


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """256 cards as 32 x 8 (data, model); two such pods as 2 x 32 x 8
    (pod, data, model), as the JAX module's 16x16 and 2x16x16."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 32, NODE_CARDS))
    return Mesh(("data", "model"), (32, NODE_CARDS))


def make_edge_mesh(n_chips: int = 4) -> Mesh:
    """A small mesh standing in for an edge-class server slice."""
    return Mesh(("data", "model"), (1, n_chips))

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
