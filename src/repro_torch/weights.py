"""Convert the JAX package's parameter tree into the port's dict."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy torch can own
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(np_tree, dtype=None, device=None):
    """Nested dict of numpy arrays (the JAX params after ``np.asarray``)
    -> the same nested dict of tensors, keys and shapes unchanged.
    ``dtype=None`` keeps each leaf's own type."""
    device = resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dtype, device)

    return conv(np_tree)
