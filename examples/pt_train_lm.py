"""End-to-end training example on the PyTorch port: train an assigned
architecture (reduced config) on the synthetic LM pipeline with
fault-tolerant checkpointing, stop at half the steps (a simulated
preemption), then "restart" and auto-resume from the last atomic
checkpoint (after ``examples/train_lm.py``).  Runs on the CUDA card unless
``--device cpu`` is given.

Run:  python examples/pt_train_lm.py [--arch gemma3-1b] [--steps 200] \\
          [--device cpu]
"""
import argparse
import shutil
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.launch.train import train  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen2-0.5b")
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--ckpt-every", type=int, default=20)
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

ckpt = tempfile.mkdtemp(prefix="repro_torch_train_")
try:
    half = args.steps // 2
    print(f"=== phase 1: train to step {half} (simulated preemption) ===")
    train(args.arch, steps=half, batch=args.batch, seq=args.seq,
          ckpt_dir=ckpt, ckpt_every=args.ckpt_every, device=args.device)
    print("=== phase 2: 'restart' — auto-resume from the last atomic "
          "checkpoint ===")
    _, losses = train(args.arch, steps=args.steps, batch=args.batch,
                      seq=args.seq, ckpt_dir=ckpt,
                      ckpt_every=args.ckpt_every, device=args.device)
    print(f"final loss {losses[-1]:.4f} (started ~{losses[0]:.4f})")
finally:
    shutil.rmtree(ckpt, ignore_errors=True)
