"""AdamW, schedules and clipping over the port's dict trees of tensors
(a port of ``repro/train/optimizer.py``; not ``torch.optim.AdamW``).

The arithmetic is the JAX package's, in its order: gradients widened to
fp32, clipped by the global norm and cast back to their type; first and
second moments in fp32; bias correction ``1 - b ** step`` in fp32;
decoupled weight decay on the fp32 value.  Parameters stored in a low
precision keep an fp32 master copy in the state, and the stored
parameters are the master cast to their type.

Unlike the JAX package's pure functions, ``adamw_update`` updates the
state (m, v, master) and the parameters in place, to hold no second copy
of a 0.5 B-parameter model's 7.9 GB of training state on the card; it
returns the same trees.  Every scalar (step, lr, the corrections) stays a
tensor on the parameters' device, so an update never waits on the host.
Trees are walked in sorted key order, as ``jax.tree_util`` walks dicts,
so the global norm adds the leaves in the JAX package's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

Tree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the parameters' device
    m: Tree
    v: Tree
    master: Tree  # fp32 copy when params are low precision, else None


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | constant
    min_lr_ratio: float = 0.1


def tree_paths(tree: Tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup, then cosine / linear decay to ``min_lr_ratio`` (or
    constant), in fp32 as the JAX package computes it."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(_f32(math.pi, step) * frac))
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * (1 - frac)
    else:
        decay = _f32(1.0, step)
    return cfg.lr * warm * decay


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in sorted order, of each leaf's sum
    of squares in fp32."""
    total = None
    for leaf in leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree: Tree, max_norm: float):
    """(the tree scaled by min(1, max_norm / (norm + 1e-9)) in fp32 and
    cast back to each leaf's type, the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def adamw_init(params: Tree) -> AdamWState:
    """Zero moments in fp32; an fp32 master copy when any parameter is
    stored in a low precision."""
    flat = leaves(params)
    m = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    v = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)
    low = any(p.dtype != torch.float32 for p in flat)
    master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                       params)
              if low else None)
    step = torch.zeros((), dtype=torch.int32, device=flat[0].device)
    return AdamWState(step, m, v, master)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: AdamWState):
    """One AdamW step; returns (params, state, {"grad_norm", "lr"}), the
    parameters and the state's m, v and master updated in place."""
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)
    ref = state.master if state.master is not None else params
    for path, p32 in tree_paths(ref):
        g = _at(grads, path).float()
        m, v = _at(state.m, path), _at(state.v, path)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p32
        p32.sub_(lr * upd)
        if state.master is not None:
            _at(params, path).copy_(p32)
    return (params, AdamWState(step, state.m, state.v, state.master),
            {"grad_norm": gnorm, "lr": lr})


def _at(tree: Tree, path: str):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


# ------------------------------------------------------------------ SGD (for
# the tiny DRL nets the paper trains with Adam defaults; kept for ablations)


@torch.no_grad()
def sgd_update(params: Tree, grads: Tree, lr: float) -> Tree:
    """p - lr g (g cast to p's type), as new tensors."""
    return tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
