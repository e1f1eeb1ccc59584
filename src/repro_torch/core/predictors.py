"""MGQP (generation-quality) and MILP (inference-latency) predictors
(paper Sec. IV-A) with their training loops.

Port of ``repro/core/predictors.py``.
MGQP: extractor -> 2-layer head -> 2-way logits, Focal loss (Eq. 15).
MILP: extractor -> 2-layer head -> scalar latency [s], Huber loss (Eq. 17).

The JAX package's hand-written Adam is ``torch.optim.Adam`` with betas
(0.9, 0.999), eps 1e-8 and no weight decay (``d3qn.adam``), step for
step.  A training set lives on the predictor's device for the whole fit;
each epoch's order is the JAX package's numpy permutation, and its losses
reach the host once an epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import extractor as ex
from repro_torch.core.d3qn import adam
from repro_torch.device import resolve
from repro_torch.nn.spec import TensorSpec, init_params

_INT_KEYS = ("model_id", "device_id", "label")


def head_spec(out_dim: int):
    return {
        "w1": TensorSpec((ex.FUSED_DIM, 32), (None, None), "normal",
                         ex.FUSED_DIM ** -0.5),
        "b1": TensorSpec((32,), (None,), "zeros"),
        "w2": TensorSpec((32, out_dim), (None, None), "normal", 32 ** -0.5),
        "b2": TensorSpec((out_dim,), (None,), "zeros"),
    }


def head_apply(p, f, *, generator=None, dropout=0.1, deterministic=True):
    h = F.gelu(f @ p["w1"] + p["b1"], approximate="tanh")
    if not deterministic and dropout > 0:
        h = ex.apply_dropout(h, generator, dropout)
    return h @ p["w2"] + p["b2"]


def focal_loss(logits, labels, *, alpha: float, gamma: float = 2.0):
    """Eq. 15: labels in {0, 1}; alpha weights the positive class."""
    logp = F.log_softmax(logits, -1)
    log_pt = logp.gather(1, labels.long()[:, None])[:, 0]
    p_t = log_pt.exp()
    a_t = torch.where(labels == 1, alpha, 1.0 - alpha)
    return -(a_t * (1 - p_t) ** gamma * log_pt).mean()


def huber_loss(pred, target, *, delta: float = 1.0):
    """Eq. 17."""
    r = pred - target
    ar = r.abs()
    return torch.where(ar <= delta, 0.5 * r * r,
                       delta * ar - 0.5 * delta * delta).mean()


@dataclasses.dataclass
class PredictorConfig:
    lr: float = 1e-3
    epochs: int = 50
    batch: int = 256
    dropout: float = 0.1
    gamma: float = 2.0  # focal
    delta: float = 1.0  # huber
    seed: int = 0
    log_t: bool = True  # regress log1p(latency_s) for the heavy tail


class Predictor:
    """One class for MGQP (kind='quality') and MILP (kind='latency'),
    on ``device`` (the card unless the caller says ``"cpu"``)."""

    def __init__(self, kind: str, n_models: int, n_devices: int,
                 cfg: PredictorConfig | None = None, feat_dim: int = 768,
                 device=None):
        if kind not in ("quality", "latency"):
            raise ValueError(f"kind must be 'quality' or 'latency': {kind!r}")
        self.kind = kind
        self.cfg = cfg or PredictorConfig()
        self.device = resolve(device)
        self.params = init_params(
            {"ext": ex.extractor_spec(feat_dim, n_models, n_devices),
             "head": head_spec(2 if kind == "quality" else 1)},
            self.cfg.seed, device=self.device)
        self._alpha = 0.5

    def tensors(self, data: dict) -> dict:
        """``data``'s arrays as tensors on the predictor's device: ids and
        labels as int64, the rest as they are."""
        out = {}
        for k, v in data.items():
            t = torch.as_tensor(v, device=self.device)
            out[k] = t.long() if k in _INT_KEYS else t
        return out

    # ------------------------------------------------------------ forward
    def _raw(self, params, batch, generator=None, deterministic=True):
        f = ex.extract(params["ext"], batch["f_text"], batch["f_img"],
                       batch["model_id"], batch["device_id"],
                       generator=generator, dropout=self.cfg.dropout,
                       deterministic=deterministic)
        return head_apply(params["head"], f, generator=generator,
                          dropout=self.cfg.dropout,
                          deterministic=deterministic)

    @torch.no_grad()
    def predict(self, batch) -> np.ndarray:
        """quality -> P(success) [B]; latency -> seconds [B]."""
        out = self._raw(self.params, self.tensors(batch))
        if self.kind == "quality":
            return torch.softmax(out, -1)[:, 1].cpu().numpy()
        t = out[:, 0].cpu().numpy()
        return np.expm1(t) if self.cfg.log_t else t

    # ------------------------------------------------------------ training
    def _loss(self, params, batch, generator):
        out = self._raw(params, batch, generator=generator,
                        deterministic=False)
        if self.kind == "quality":
            return focal_loss(out, batch["label"], alpha=self._alpha,
                              gamma=self.cfg.gamma)
        target = batch["latency_s"]
        if self.cfg.log_t:
            target = torch.log1p(target)
        return huber_loss(out[:, 0], target, delta=self.cfg.delta)

    def fit(self, data: dict, val: dict | None = None, verbose=False
            ) -> "list[dict[str, Any]]":
        """data: arrays f_text [N,768], f_img [N,768], model_id, device_id,
        label / latency_s.  Returns per-epoch history."""
        cfg = self.cfg
        n = len(data["model_id"])
        if self.kind == "quality":
            pos = float((np.asarray(data["label"]) == 1).mean())
            self._alpha = 1.0 - pos  # weight positives by class imbalance
        opt = adam(self.params, cfg.lr)
        train = self.tensors(data)
        val = self.tensors(val) if val is not None else None
        rng = np.random.default_rng(cfg.seed)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        hist = []
        for epoch in range(cfg.epochs):
            order = rng.permutation(n)
            losses = []
            for s in range(0, n - cfg.batch + 1, cfg.batch):
                idx = torch.as_tensor(order[s:s + cfg.batch],
                                      device=self.device)
                batch = {k: v[idx] for k, v in train.items()}
                loss = self._loss(self.params, batch, gen)
                opt.zero_grad()
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            # the mean of the steps' fp32 losses taken in float64, as
            # np.mean over Python floats takes it
            losses = (torch.stack(losses).double().cpu().numpy() if losses
                      else np.zeros(0))
            rec = {"epoch": epoch, "train_loss": float(np.mean(losses))}
            rec.update(self.evaluate(train, prefix="train_"))
            if val is not None:
                rec.update(self.evaluate(val, prefix="val_"))
            hist.append(rec)
            if verbose:
                print(rec, flush=True)
        return hist

    @torch.no_grad()
    def evaluate(self, data: dict, prefix="") -> dict:
        batch = self.tensors(data)
        out = self._raw(self.params, batch)
        if self.kind == "quality":
            p = torch.softmax(out, -1)[:, 1].cpu().numpy()
            pred = (p > 0.5).astype(np.int32)
            acc = float((pred == batch["label"].cpu().numpy()).mean())
            loss = float(focal_loss(out, batch["label"], alpha=self._alpha,
                                    gamma=self.cfg.gamma))
            return {prefix + "acc": acc, prefix + "loss": loss}
        t = out[:, 0].cpu().numpy()
        t = np.expm1(t) if self.cfg.log_t else t
        lat = batch["latency_s"]
        mae = float(np.abs(t - lat.cpu().numpy()).mean())
        tt = torch.log1p(lat) if self.cfg.log_t else lat
        loss = float(huber_loss(out[:, 0], tt, delta=self.cfg.delta))
        return {prefix + "mae_s": mae, prefix + "loss": loss}
