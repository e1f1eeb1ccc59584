"""PyTorch / CUDA port of the ``repro`` serving stack for one NVIDIA H100.

Imports ``torch``, numpy and the standard library only.  Module and public
function names follow the JAX package so each counterpart is easy to find.
Entry points take an explicit ``device`` and run on ``cuda`` unless the
caller passes ``device="cpu"`` (see ``repro_torch.device.resolve``).
"""
