"""Roofline terms of a traced torch call: the counterpart of
``repro/launch/hlo_analysis.py``, which parses XLA's compiled HLO.

``Counter`` is a ``TorchDispatchMode``; under it a call runs on any
device (the dry run uses ``meta`` tensors, which hold no storage) and
every aten op it issues is counted:

  * FLOPs       -- 2 * M * N * K for every matrix product (``mm``,
                   ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``, and
                   so the products inside ``einsum``, ``matmul`` and
                   ``linear``): the quantity ``hlo_analysis._dot_flops``
                   counts for a ``dot``.
  * HBM bytes   -- each op's inputs and outputs once (a broadcast
                   dimension, stride 0, once), skipping views and
                   allocations, as ``_SKIP_BYTES`` skips bitcasts and
                   reshapes: what eager issue moves.  A gather counts its
                   indices and the rows it reads and writes, an in-place
                   scatter its indices and values and the rows it writes,
                   not the whole tensor they index.  A kernel wrapper's
                   call (``device.kernel_wrapper``) counts as its own
                   inputs and outputs once, as ``PERF.md`` section 6's
                   bounds count them, not as its plain version's steps;
                   the plain version's products still count as FLOPs.
  * peak bytes  -- the peak of the storages created during the call and
                   still alive, counted when an op creates them and
                   released when they are freed (a kernel wrapper's
                   scratch and its plain version's intermediates are not
                   counted, only its outputs): the torch meaning of XLA's
                   ``temp_size_in_bytes``.

Collective bytes are 0 on one card.  On a mesh (``dryrun.py --mesh``) the
dry run reckons per-device arguments only: eager torch has no GSPMD
partitioner to lower a cell's program per device, so its temp and
collective bytes are not known there.

``hlo_analysis.py``'s HLO-text parser (``parse_hlo``,
``_multiplicities``, the fusion refinements) and ``reanalyze.py`` read
XLA's optimized HLO and have no torch counterpart.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.device import observe_kernels
from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

aten = torch.ops.aten


def _mm(a, b, *_):
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _addmm(_, a, b, *__, **___):
    return _mm(a, b)


def _bmm(a, b, *_):
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _baddbmm(_, a, b, *__, **___):
    return _bmm(a, b)


_FLOPS = {aten.mm.default: _mm, aten.addmm.default: _addmm,
          aten.bmm.default: _bmm, aten.baddbmm.default: _baddbmm,
          aten.mv.default: lambda a, b: 2 * a.shape[0] * a.shape[1],
          aten.dot.default: lambda a, b: 2 * a.shape[0]}

# allocations, reads of metadata and ``_unsafe_view`` (a reshape that
# aten does not mark as a view) move no bytes
_SKIP_BYTES = {aten._unsafe_view.default,
               aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten.lift_fresh.default,
               aten._local_scalar_dense.default, aten.sym_size.int,
               aten.sym_stride.int, aten.sym_numel.default}


# gathers read only the rows they gather, and in-place scatters write only
# the rows they scatter: their bytes are the indices, the gathered or
# scattered values, and the region read or written (XLA's analysis counts
# a dynamic-update-slice as twice its update)
_GATHERS = {aten.index.Tensor, aten.gather.default, aten.index_select.default,
            aten.embedding.default}
_SCATTERS = {aten.index_put_.default, aten._index_put_impl_.default,
             aten.index_copy_.default, aten.scatter_.src,
             aten.scatter_.value, aten.scatter_add_.default,
             aten.index_add_.default}


def _op_bytes(func, args, kwargs, out) -> int:
    if func in _GATHERS:
        return (sum(tensor_bytes(t) for t in _tensors((args[1:], kwargs)))
                + 2 * sum(tensor_bytes(t) for t in _tensors(out)))
    if func in _SCATTERS:
        return 2 * sum(tensor_bytes(t) for t in _tensors((args[1:], kwargs)))
    return sum(tensor_bytes(t) for t in _tensors((args, kwargs, out)))


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses: a broadcast
    dimension (stride 0) counts once."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class Counter(TorchDispatchMode):
    """Counts a call's FLOPs, HBM bytes and peak of live storage bytes
    (module docstring); ``products`` holds how many products of each FLOP
    count it made and ``kernel_calls`` the kernel wrappers' calls.
    ``arguments`` are the call's inputs: their storages are arguments,
    not temporaries, whatever the call does to them in place.

        with Counter(args) as c:
            out = fn(*args)
        c.flops, c.hbm_bytes, c.peak_bytes, c.output_bytes(out)
    """

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.kernel_calls: dict = {}
        self.products = collections.Counter()  # FLOPs of each product
        self._args = {t.untyped_storage()._cdata for t in _tensors(arguments)}
        self._live: dict = {}  # storage key -> bytes
        self._in_kernel = 0

    def __enter__(self):
        self._observing = observe_kernels(self)
        self._observing.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._observing.__exit__(*exc)

    # --------------------------------------------------------- storages
    def _release(self, key, nbytes):
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _track(self, outs):
        for t in _tensors(outs):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._args or key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = nbytes
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._release, key, nbytes)

    def output_bytes(self, out) -> int:
        """Bytes of the storages ``out`` holds that the call created."""
        keys = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in _tensors(out)}
        return sum(n for k, n in keys.items() if k not in self._args)

    # ------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops = _FLOPS.get(func)
        if flops is not None:
            n = flops(*args, **kwargs)
            self.flops += n
            self.products[n] += 1
        if self._in_kernel:
            return out
        if not func.is_view and func not in _SKIP_BYTES:
            self.hbm_bytes += _op_bytes(func, args, kwargs, out)
        self._track(out)
        return out

    def kernel(self, name, fn, args, kwargs):
        """One kernel wrapper's call (``device.kernel_wrapper``): its
        inputs and outputs once; its plain version's products as FLOPs."""
        self._in_kernel += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._in_kernel -= 1
        if not self._in_kernel:
            self.hbm_bytes += sum(tensor_bytes(t) for t in _tensors(
                (args, kwargs, out)))
            self._track(out)
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        return out


@dataclasses.dataclass
class Roofline:
    """``hlo_analysis.Roofline``'s fields and properties over one H100's
    peaks (``mesh.py``)."""

    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / self.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_total(self) -> float:  # no-overlap upper bound
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }
