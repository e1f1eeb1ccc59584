"""How often a ``torch.profiler`` session on the card records no device
time, and whether such sessions come one at a time or in runs.

    PYTHONPATH=src python scripts/profiler_gaps.py [SECONDS]
    TEARDOWN_CUPTI=0 PYTHONPATH=src python scripts/profiler_gaps.py [SECONDS]

For SECONDS (default 25) per case, it profiles window after window of 20
calls of the port's flash-attention kernel, device activity only, as
``chip_smoke.py``'s ``device_ms`` does: the fp32 encoder shape (B 4, S
256, two heads of 448, non-causal) and a bf16 causal prefill at qwen2-0.5b
heads (B 1, S 1024, 14/2 heads of 64).  It prints one JSON line: for each
case the number of sessions, the median reading (us of device time for
the 20 calls), the sessions that read nothing and those that read less
than 0.9 of the median, with the indices of the first 40 of each.
``TEARDOWN_CUPTI=0`` keeps CUPTI subscribed between sessions (Kineto
tears it down after each by default).  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

from repro_torch.kernels.flash_attention import flash_attention

CALLS = 20


def dev_us(e) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return getattr(e, name)
    return 0


def sessions(fn, seconds: float) -> list[float]:
    """Device microseconds of each profiled window of ``CALLS`` calls."""
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    readings = []
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        readings.append(sum(dev_us(e) for e in prof.key_averages()
                            if getattr(e, "device_type", None) == cuda))
    return readings


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 25.0
    dev = torch.device("cuda")

    def inputs(B, S, H, Hkv, D, dt):
        return (torch.randn(B, S, H, D, device=dev, dtype=dt),
                torch.randn(B, S, Hkv, D, device=dev, dtype=dt),
                torch.randn(B, S, Hkv, D, device=dev, dtype=dt))

    enc = inputs(4, 256, 2, 2, 448, torch.float32)
    pre = inputs(1, 1024, 14, 2, 64, torch.bfloat16)
    out = {"TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"),
           "card": torch.cuda.get_device_name(0)}
    for label, fn in (
            ("fp32 encoder", lambda: flash_attention(*enc, causal=False)),
            ("bf16 prefill", lambda: flash_attention(*pre, causal=True))):
        r = sessions(fn, seconds)
        med = sorted(r)[len(r) // 2]
        empty = [i for i, x in enumerate(r) if x == 0]
        short = [i for i, x in enumerate(r) if 0 < x < 0.9 * med]
        out[label] = dict(sessions=len(r), median_us=med, empty=len(empty),
                          empty_at=empty[:40], short=len(short),
                          short_at=short[:40])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
