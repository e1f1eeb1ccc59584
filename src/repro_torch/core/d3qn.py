"""Dueling Double Deep Q-Network (paper Sec. IV-B, Fig. 4).

Port of ``repro/core/d3qn.py``.  The evaluation network mirrors Fig. 4:
the QLMIO multimodal extractor branches (text/image projections + per-
server meta embeddings) fuse to a 32-d representation, concatenated with
the MILP-predicted latencies, the estimated queue loads (Eq. 19) and the
MGQP success probabilities (3 x (E+1) scalars), through a 256-256 trunk
into dueling value/advantage heads.  Q = V + A - mean(A) (the paper's
Eq. 22 prints "+ mean"; the JAX package follows the standard dueling
estimator and the cited D3QN reference; see README.md).

The replay buffer and the exploration draws are the JAX package's numpy
code; the greedy action is ``np.argmax`` on the host, so ties resolve as
there.  Its hand-written Adam is ``torch.optim.Adam`` (betas 0.9, 0.999,
eps 1e-8), step for step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.nn.spec import TensorSpec, init_params, tree_leaves

META_EMB = 16
FUSED = 32
TRUNK = 256

_INT_KEYS = ("model_ids", "device_ids")


def _lin(i, o):
    return {"w": TensorSpec((i, o), (None, None), "normal", i ** -0.5),
            "b": TensorSpec((o,), (None,), "zeros"),
            "ln_s": TensorSpec((o,), (None,), "ones"),
            "ln_b": TensorSpec((o,), (None,), "zeros")}


def qnet_spec(n_actions: int, n_models: int, n_devices: int,
              feat_dim: int = 768, use_task_features: bool = True):
    spec = {
        "emb_model": TensorSpec((n_models, META_EMB), (None, None),
                                "normal", 0.02),
        "emb_device": TensorSpec((n_devices, META_EMB), (None, None),
                                 "normal", 0.02),
        "fuse1": _lin((2 * 64 if use_task_features else 0)
                      + n_actions * 2 * META_EMB, 64),
        "fuse2": _lin(64, FUSED),
        "trunk1": _lin(FUSED + 3 * n_actions, TRUNK),
        "trunk2": _lin(TRUNK, TRUNK),
        "value": {"w": TensorSpec((TRUNK, 1), (None, None), "normal",
                                  TRUNK ** -0.5),
                  "b": TensorSpec((1,), (None,), "zeros")},
        "adv": {"w": TensorSpec((TRUNK, n_actions), (None, None), "normal",
                                TRUNK ** -0.5),
                "b": TensorSpec((n_actions,), (None,), "zeros")},
    }
    if use_task_features:
        spec["proj_text"] = _lin(feat_dim, 64)
        spec["proj_img"] = _lin(feat_dim, 64)
    return spec


def _apply_lin(p, x, act=True):
    h = (x @ p["w"] + p["b"]).float()
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, correction=0)
    h = (h - mu) * torch.rsqrt(var + 1e-5) * p["ln_s"] + p["ln_b"]
    return F.gelu(h, approximate="tanh") if act else h


def q_values(params, state: dict) -> torch.Tensor:
    """state: f_text [B,D], f_img [B,D], model_ids [B,A], device_ids [B,A],
    t_hat [B,A], q_load [B,A], b_hat [B,A]  ->  Q [B,A]."""
    B, A = state["model_ids"].shape
    branches = []
    if "proj_text" in params:
        branches.append(_apply_lin(params["proj_text"], state["f_text"]))
        branches.append(_apply_lin(params["proj_img"], state["f_img"]))
    em = params["emb_model"][state["model_ids"]].reshape(B, -1)
    ed = params["emb_device"][state["device_ids"]].reshape(B, -1)
    branches += [em, ed]
    fused = _apply_lin(params["fuse2"],
                       _apply_lin(params["fuse1"], torch.cat(branches, -1)))
    x = torch.cat([fused, state["t_hat"], state["q_load"], state["b_hat"]],
                  -1)
    h = _apply_lin(params["trunk2"], _apply_lin(params["trunk1"], x))
    v = h @ params["value"]["w"] + params["value"]["b"]  # [B,1]
    a = h @ params["adv"]["w"] + params["adv"]["b"]  # [B,A]
    return v + a - a.mean(-1, keepdim=True)  # Eq. 22 (sign fixed)


def to_tensors(arrays: dict, device, prefix: str = "") -> dict:
    """The entries of ``arrays`` whose keys start with ``prefix``, the
    prefix dropped, as tensors on ``device``: ids as int64, the rest as
    fp32."""
    out = {}
    for k, v in arrays.items():
        if k.startswith(prefix):
            name = k[len(prefix):]
            out[name] = torch.as_tensor(
                v, dtype=torch.int64 if name in _INT_KEYS else torch.float32,
                device=device)
    return out


def split_batch(batch: dict, device):
    """A replay sample as (state, next state, reward, done, action)
    tensors on ``device``."""
    return (to_tensors(batch, device, "s_"), to_tensors(batch, device, "n_"),
            torch.as_tensor(batch["reward"], dtype=torch.float32,
                            device=device),
            torch.as_tensor(batch["done"], dtype=torch.float32,
                            device=device),
            torch.as_tensor(batch["action"], dtype=torch.int64,
                            device=device))


def adam(params, lr: float) -> torch.optim.Adam:
    """The JAX package's hand-written Adam over every leaf of
    ``params``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0, foreach=True)


@torch.no_grad()
def soft_update(target, params, tau: float):
    """target <- tau * params + (1 - tau) * target, leaf by leaf."""
    tgt = tree_leaves(target)
    torch._foreach_mul_(tgt, 1 - tau)
    torch._foreach_add_(tgt, torch._foreach_mul(tree_leaves(params), tau))


def clone_tree(tree):
    """A detached copy of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


class Replay:
    def __init__(self, capacity: int, state_shapes: dict):
        self.capacity = capacity
        self.n = 0
        self.ptr = 0
        self.buf = {k: np.zeros((capacity,) + tuple(s), dt)
                    for k, (s, dt) in state_shapes.items()}

    def add(self, rec: dict):
        for k, v in rec.items():
            self.buf[k][self.ptr] = v
        self.ptr = (self.ptr + 1) % self.capacity
        self.n = min(self.n + 1, self.capacity)

    def sample(self, batch: int, rng: np.random.Generator) -> dict:
        idx = rng.integers(0, self.n, batch)
        return {k: v[idx] for k, v in self.buf.items()}


@dataclasses.dataclass
class D3QNConfig:
    lr: float = 1e-4  # paper Table IV
    gamma: float = 0.95
    batch: int = 256
    train_interval: int = 5  # paper Table IV (S)
    replay: int = 10_000  # paper Table IV (|M|)
    tau: float = 0.005  # paper Table IV
    eps_start: float = 1.0  # paper Table IV
    eps_end: float = 0.05
    eps_decay_steps: int = 30_000
    seed: int = 0


class D3QNAgent:
    """Generic dueling-double-DQN over the Fig. 4 state, on ``device``
    (the card unless the caller says ``"cpu"``)."""

    def __init__(self, n_actions: int, n_models: int, n_devices: int,
                 cfg: D3QNConfig | None = None, feat_dim: int = 768,
                 use_task_features: bool = True, device=None):
        self.cfg = cfg or D3QNConfig()
        self.n_actions = n_actions
        self.device = resolve(device)
        spec = qnet_spec(n_actions, n_models, n_devices, feat_dim,
                         use_task_features)
        self.params = init_params(spec, self.cfg.seed, device=self.device)
        self.target = clone_tree(self.params)
        self.opt = adam(self.params, self.cfg.lr)
        self.rng = np.random.default_rng(self.cfg.seed)
        self.step_count = 0

    # ------------------------------------------------------------- acting
    def epsilon(self) -> float:
        c = self.cfg
        frac = min(1.0, self.step_count / c.eps_decay_steps)
        return c.eps_start + (c.eps_end - c.eps_start) * frac

    def act(self, state: dict, greedy: bool = False) -> int:
        if not greedy and self.rng.random() < self.epsilon():
            return int(self.rng.integers(self.n_actions))
        with torch.no_grad():
            q = q_values(self.params, to_tensors(
                {k: np.asarray(v)[None] for k, v in state.items()},
                self.device))
        return int(np.argmax(q.cpu().numpy()[0]))

    # ------------------------------------------------------------- update
    def _loss(self, batch: dict) -> torch.Tensor:
        c = self.cfg
        s, s2, r, done, a = split_batch(batch, self.device)
        # double DQN target, from the parameters before this update
        with torch.no_grad():
            a_star = q_values(self.params, s2).argmax(-1)
            q_next_tgt = q_values(self.target, s2)
            y = r + c.gamma * (1 - done) * q_next_tgt.gather(
                1, a_star[:, None])[:, 0]
        q_a = q_values(self.params, s).gather(1, a[:, None])[:, 0]
        err = q_a - y
        return torch.where(err.abs() <= 1.0, 0.5 * err * err,
                           err.abs() - 0.5).mean()

    def train_step(self, batch) -> float:
        loss = self._loss(batch)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        return float(loss.detach())

    def soft_update(self):
        soft_update(self.target, self.params, self.cfg.tau)
