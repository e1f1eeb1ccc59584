"""Whether a ``torch.profiler`` session on the card records every RMSNorm
kernel launched in its window, and which one it misses when it does not.

    PYTHONPATH=src python scripts/profiler_first_kernel.py [SESSIONS]

Each case profiles SESSIONS (default 200) windows, device activity only,
as ``chip_smoke.py``'s ``profile_train_step`` does, of 12 calls of the
port's RMSNorm kernel on [8192, 896] bf16 rows (a training step's norm),
preceded by:
  * nothing (the kernel is the window's first launch);
  * a token clamp and an embedding gather (a training step's first two
    kernels, then its first norm);
  * a sleep kernel of about 1 ms (``torch.cuda._sleep``).
Each session runs after a ``torch.cuda.synchronize()``.
It prints one JSON line: for each case the number of sessions and how
many recorded each count of RMSNorm kernels.  Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import collections
import json
import sys

import torch

from repro_torch.kernels.rmsnorm import rmsnorm

CALLS = 12


def rms_count(prof) -> int:
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.count for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda
               and "rmsnorm_kernel" in e.key)


def main():
    sessions = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    dev = torch.device("cuda")
    x = torch.randn(8192, 896, device=dev, dtype=torch.bfloat16)
    s = torch.ones(896, device=dev, dtype=torch.bfloat16)
    table = torch.randn(151936, 896, device=dev, dtype=torch.bfloat16)
    tokens = torch.randint(0, 151936, (8, 1024), device=dev)

    def first():
        pass

    def embed():
        table[tokens.clamp(min=0)]

    def sleep():
        torch.cuda._sleep(1_000_000)

    out = {"card": torch.cuda.get_device_name(0), "calls": CALLS}
    for label, before in (("rmsnorm first", first),
                          ("after clamp and gather", embed),
                          ("after a sleep kernel", sleep)):
        hist = collections.Counter()
        for _ in range(sessions):
            torch.cuda.synchronize()
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            with prof:
                before()
                for _ in range(CALLS):
                    rmsnorm(x, s)
                torch.cuda.synchronize()
            hist[rms_count(prof)] += 1
        out[label] = {"sessions": sessions,
                      "recorded": {str(k): v for k, v in sorted(hist.items())}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
