"""Kernel entry points of the port, mirroring ``repro/kernels/ops.py`` for
the kernels ported so far.  Each runs its CUDA kernel on CUDA tensors and
its plain PyTorch version on CPU tensors (the dispatch is inside the
wrapper, keyed by the tensors' device)."""
from repro_torch.kernels.paged_decode import paged_decode  # noqa: F401
from repro_torch.kernels.paged_decode import paged_decode_quant  # noqa: F401
