"""What two design choices of the bf16 backward kernels are worth on the
card: each source is built as it stands and with one choice undone (a text
substitution of the source), and the builds are timed in turn.

    PYTHONPATH=src python scripts/bwd_kernel_variants.py

* ``csrc/moe_gmm_bwd.cu``: as built, and with the epilogue's TMA stores
  left out (the accumulators still go through shared memory), which bounds
  what the stores cost; CUDA events over 30 calls at granite-moe-1b-a400m's
  gate/up and down shapes (C 2560) and qwen2-moe-a2.7b's expert shape.
* ``csrc/ssd_scan_bwd.cu``: as built, and with the products' trip counts
  read at run time at p = n = 64 too (the instantiations for other widths);
  each kernel's device time under ``torch.profiler`` at zamba2-2.7b's B 4 x
  S 1024 (80 heads of 64, state 64, chunk 256, bf16 x).

Each variant is built by ``nvcc`` with ``kernels/build.py``'s flags into
``build/bwd_variants/``, and the variants run in the order as built, the
other, the other, as built.  Prints the card's name and power limit, then
one line per reading.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ssd_scan as sk

OUT = Path(__file__).resolve().parents[1] / "build" / "bwd_variants"
GMM_SHAPES = [("granite-moe gate/up", 32, 2560, 1024, 512),
              ("granite-moe down", 32, 2560, 512, 1024),
              ("qwen2-moe expert shape", 60, 688, 2048, 1408)]
VARIANTS = {
    "moe_gmm_bwd": {
        "without the TMA stores": [(
            "          wg::tma_store_3d(map, out + q * kBox, tl.n0 + 64 * q,",
            "          if (q < 0) wg::tma_store_3d(map, out + q * kBox, "
            "tl.n0 + 64 * q,")]},
    "ssd_scan_bwd": {
        "trip counts read at run time": [(
            "  const bool wide = tcb::pad16(P) == 64 && tcb::pad16(N) == 64;",
            "  const bool wide = false;")]},
}


def build_variant(name: str, label: str, subs: list) -> ctypes.CDLL:
    """csrc/<name>.cu with the substitutions (each must apply), built and
    loaded."""
    src = (build.CSRC / f"{name}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: the variant '{label}' no longer "
                               f"applies: {old!r} is not in the source")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    tag = "as_built" if not subs else label.replace(" ", "_")
    path = OUT / f"{name}-{tag}.cu"
    path.write_text(src)
    lib = OUT / f"{name}-{tag}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(path)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def events_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def gmm(libs: dict):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.grouped_matmul_bwd_launch.argtypes = ([i32] + [ptr] * 5
                                                  + [i32] * 8 + [ptr])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    names = list(libs)
    for label, E, C, K, N in GMM_SHAPES:
        x, w, dy = (torch.randn(s, device="cuda", dtype=torch.bfloat16)
                    for s in ((E, C, K), (E, K, N), (E, C, N)))
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        stream = torch.cuda.current_stream().cuda_stream
        readings = []
        for name in (names[0], names[1], names[1], names[0]):
            lib = libs[name]

            def call(lib=lib):
                err = lib.grouped_matmul_bwd_launch(
                    1, x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                    dx.data_ptr(), dw.data_ptr(), E, C, K, N, 1, 1, 1, sms,
                    stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            readings.append(f"{name} {events_ms(call):.4f}")
        want = mg.grouped_matmul_bwd_ref(x, w, dy)
        print(f"grouped_matmul_bwd, {label} (E {E}, C {C}, K {K}, N {N}), "
              "ms a call by CUDA events: " + "; ".join(readings)
              + f" (dx of the last call off {_rel(dx, want[0]):.2e})",
              flush=True)


def _short(kernel: str) -> str:
    """A profiler kernel name without its namespace and arguments."""
    name = kernel.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def scan(libs: dict):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.ssd_scan_bwd_launch.argtypes = [i32] + [ptr] * 14 + [i32] * 6 \
            + [ptr]
    b, S, h, p, n, Q = 4, 1024, 80, 64, 64, 256
    x = torch.randn(b, S, h, p, device="cuda").bfloat16()
    dt = torch.rand(b, S, h, device="cuda") * 0.2 + 0.01
    a_neg = -torch.rand(h, device="cuda") * 2 - 0.5
    B, C = (torch.randn(b, S, n, device="cuda").bfloat16() for _ in "BC")
    dy = torch.randn(b, S, h, p, device="cuda")
    outs = [torch.empty_like(t) for t in (x, dt, a_neg, B, C)]
    scratch = torch.empty(sk.bwd_scratch_bytes(b, S, h, p, n, Q) // 4,
                          device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    names = list(libs)
    for name in (names[0], names[1], names[1], names[0]):
        lib = libs[name]

        def call(lib=lib):
            err = lib.ssd_scan_bwd_launch(
                1, x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(),
                B.data_ptr(), C.data_ptr(), None, dy.data_ptr(), None,
                *(t.data_ptr() for t in outs), scratch.data_ptr(), b, S, h,
                p, n, Q, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        parts = {_short(e.key): e.self_device_time_total / 10 / 1e3
                 for e in prof.key_averages()
                 if e.device_type == cuda and e.self_device_time_total > 0}
        print(f"ssd_scan_bwd, zamba2 B {b} x S {S}, {name}: "
              f"{sum(parts.values()):.4f} ms a call of device time ("
              + "; ".join(f"{k} {v:.4f}" for k, v in parts.items()) + ")",
              flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    for name, run in (("moe_gmm_bwd", gmm), ("ssd_scan_bwd", scan)):
        libs = {"as built": build_variant(name, "as built", [])}
        for label, subs in VARIANTS[name].items():
            libs[label] = build_variant(name, label, subs)
        run(libs)


if __name__ == "__main__":
    main()
