"""Per-task frozen encoder features, computed once and cached.

Port of ``repro/core/feature_store.py``.  The frozen ViT/DistilBERT
outputs never change, so MGQP/MILP/QLMIO training needs only the cached
768-d features of each task.

The cache file is named ``pt_feats_...`` with the device type at its end:
the JAX package writes ``feats_...`` into the same directory from other
weights, and the port's weights drawn on the card differ from those drawn
on the CPU, so neither reads features the other computed.
"""
from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from repro_torch.core.encoders import (PROFILES, bert_encode,
                                       frozen_encoders, vit_encode)
from repro_torch.data.taskgen import TaskSet
from repro_torch.device import resolve


def cache_name(tasks: TaskSet, profile: str, seed: int, device) -> str:
    return (f"pt_feats_{profile}_{tasks.seed}_{tasks.n}_{seed}_"
            f"{resolve(device).type}.npz")


def _to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory
    without a wait, so the host makes the next batch while the card
    encodes this one."""
    t = torch.from_numpy(a)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def compute_features(tasks: TaskSet, profile: str = "fast", batch: int = 128,
                     cache_dir: str | None = "results/cache",
                     seed: int = 0, device=None):
    """-> (f_img [N, D], f_text [N, D]) float32 numpy arrays, encoded on
    ``device`` (the card unless the caller says ``"cpu"``)."""
    device = resolve(device)
    p = PROFILES[profile]
    path = (os.path.join(cache_dir, cache_name(tasks, profile, seed, device))
            if cache_dir else None)
    if path and os.path.exists(path):
        z = np.load(path)
        return z["f_img"], z["f_text"]
    vit, bert, _ = frozen_encoders(profile, seed, device)
    f_img, f_text = [], []
    # the procedural images are the host's work: numpy releases the GIL
    # in it, so threads make a batch's images side by side
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for s in range(0, tasks.n, batch):
            idx = np.arange(s, min(s + batch, tasks.n))
            imgs = np.stack(list(pool.map(
                lambda i: tasks.image(int(i), p.img_size), idx)))
            toks, masks = tasks.texts(idx, p.text_len, p.bert_vocab)
            f_img.append(vit_encode(vit, _to(imgs, device), p))
            f_text.append(bert_encode(bert, _to(toks, device),
                                      _to(masks, device), p))
    f_img = torch.cat(f_img).float().cpu().numpy()
    f_text = torch.cat(f_text).float().cpu().numpy()
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(path, f_img=f_img, f_text=f_text)
    return f_img, f_text
