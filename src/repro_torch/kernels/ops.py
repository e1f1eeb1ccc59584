"""Kernel entry points of the port, mirroring ``repro/kernels/ops.py`` for
the kernels ported so far.  Each runs its CUDA kernel on CUDA tensors and
its plain PyTorch version on CPU tensors (the dispatch is inside the
wrapper, keyed by the tensors' device).  The backward wrappers of the
grouped matmul and the SSD scan, which their autograd Functions call, are
re-exported beside them, and the column-stable dense product of the
projections, which replaces XLA's dot rather than a Pallas kernel."""
from repro_torch.kernels.dense_matmul import dense_matmul  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.flash_decode import flash_decode  # noqa: F401
from repro_torch.kernels.flash_decode import flash_decode_quant  # noqa: F401
from repro_torch.kernels.moe_gmm import grouped_matmul  # noqa: F401
from repro_torch.kernels.moe_gmm import grouped_matmul_bwd  # noqa: F401
from repro_torch.kernels.paged_decode import paged_decode  # noqa: F401
from repro_torch.kernels.paged_decode import paged_decode_quant  # noqa: F401
from repro_torch.kernels.paged_verify import paged_verify  # noqa: F401
from repro_torch.kernels.paged_verify import paged_verify_quant  # noqa: F401
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan_bwd  # noqa: F401
