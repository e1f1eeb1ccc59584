"""Training driver (a port of ``repro/launch/train.py``): any trainable
arch, synthetic LM data, fault-tolerant checkpointing with auto-resume.
It runs on the CUDA card unless ``--device cpu`` (``device="cpu"``) is
given.

CPU-scale example (reduced config, the default):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2-0.5b --steps 50 --batch 8 --seq 128 --ckpt-dir build/run1
Kill it mid-run and re-run the same command: it resumes from the last
atomic checkpoint.  ``--full`` trains the config at its published width
and depth (fp32 parameters, as the JAX driver's; ``train(...,
param_dtype=torch.bfloat16)`` keeps bf16 parameters with an fp32 master,
~7.9 GB of state for qwen2-0.5b).

Every arch of the zoo trains: the attention family (dense and MoE),
zamba2, xlstm and whisper, whose encoder frames are drawn at each step as
the JAX driver draws them (``np.random.default_rng(step)``, normal, fp32).
zamba2 and xlstm take a ``--seq`` of at most ``scan_chunk`` (256) or a
multiple of it, e.g.
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch zamba2-2.7b --seq 256 --batch 2 --steps 4
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.device import resolve
from repro_torch.models.api import build_model
from repro_torch.train.checkpoint import (latest_step, load_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optimizer import AdamWConfig, AdamWState, tree_map

def train(arch: str, *, steps: int, batch: int, seq: int,
          use_reduced: bool = True, ckpt_dir: str | None = None,
          ckpt_every: int = 20, lr: float = 3e-4, log_every: int = 10,
          param_dtype=torch.float32, device=None, on_step=None,
          overrides: dict | None = None):
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens
    (``SyntheticLM`` batch ``step`` at step ``step``; whisper's encoder
    frames drawn from ``np.random.default_rng(step)``), resuming from the
    newest checkpoint in ``ckpt_dir`` and saving one every ``ckpt_every``
    steps; returns (params, the losses of the steps this call ran) with
    the losses as floats.  Weights are drawn on ``device`` from seed 0
    (``Model.init``).  The losses are read on the host after the last
    step (and at each log line).  ``on_step(step, metrics)``, if given,
    is called after each step (a caller's timer or counter).
    ``overrides`` replaces fields of the config after its lookup (a depth
    cut such as ``{"n_layers": 16}``)."""
    dev = resolve(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = build_model(cfg)
    data = SyntheticLM(LMDataConfig(cfg.vocab, seq, batch))
    step_fn = model.make_train_step(
        AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5),
                    total_steps=steps))

    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        start, tree = load_checkpoint(ckpt_dir)
        params = tree_map(lambda t: t.to(dev), tree["params"])
        opt = _to_opt(tree["opt"], dev)
        print(f"[train] resumed from step {start}", flush=True)
    else:
        params = model.init(0, param_dtype, device=dev)
        opt = model.init_opt(params)

    losses = []
    t0 = time.time()
    for step in range(start, steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(step).items()}
        if cfg.cross_attention:  # the JAX driver's frames (launch/train.py)
            frames = np.random.default_rng(step).normal(
                size=(batch, cfg.encoder_seq, cfg.d_model))
            b["encoder_frames"] = torch.from_numpy(frames).float().to(dev)
        params, opt, metrics = step_fn(params, opt, b)
        losses.append(metrics["loss"])
        if on_step is not None:
            on_step(step, metrics)
        if log_every and step % log_every == 0:
            print(f"[train] step {step} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0):.0f}s)", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1,
                            {"params": params, "opt": _from_opt(opt)})
    return params, [float(x) for x in losses]


def _from_opt(opt: AdamWState) -> dict:
    return {"step": opt.step, "m": opt.m, "v": opt.v, "master": opt.master}


def _to_opt(d: dict, dev) -> AdamWState:
    def to(tree):
        return None if tree is None else tree_map(lambda t: t.to(dev), tree)

    return AdamWState(d["step"].to(dev), to(d["m"]), to(d["v"]),
                      to(d["master"]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--reduced", action="store_true",
                    help="accepted for the JAX launcher's command lines; "
                    "the reduced config is the default without --full")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    _, losses = train(args.arch, steps=args.steps, batch=args.batch,
                      seq=args.seq, use_reduced=not args.full,
                      ckpt_dir=args.ckpt_dir, lr=args.lr, device=args.device)
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} "
              f"last loss {losses[-1]:.4f}")
    else:
        print("[train] done: nothing left to run")


if __name__ == "__main__":
    main()
