"""Kernel entry points of the port, mirroring ``repro/kernels/ops.py`` for
the kernels ported so far.  Each runs its CUDA kernel on CUDA tensors and
its plain PyTorch version on CPU tensors (the dispatch is inside the
wrapper, keyed by the tensors' device)."""
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.paged_decode import paged_decode  # noqa: F401
from repro_torch.kernels.paged_decode import paged_decode_quant  # noqa: F401
from repro_torch.kernels.paged_verify import paged_verify  # noqa: F401
from repro_torch.kernels.paged_verify import paged_verify_quant  # noqa: F401
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401
