"""Fault-tolerant checkpointing: atomic write (tmp + rename), keep-N, resume
(a port of ``repro/train/checkpoint.py``, with the same API and
guarantees).

Format: ``tree.pt``, a ``torch.save`` of the flat ``{path: leaf}`` dict
(tensors moved to the CPU, ``None``, and the ``__type__`` markers of list
and tuple nodes), read back with ``weights_only=True``; plus a small JSON
metadata sidecar ``meta.json``.  A checkpoint is written into a
``.tmp.`` directory and renamed into place: the rename is the commit
point, so a writer killed mid-write leaves a tmp directory that readers
ignore and the next save removes.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Any

import torch

_SEP = "/"


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{_SEP}{k}"))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}{_SEP}__type__"] = type(tree).__name__
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}{i}"))
    elif tree is None:
        out[prefix] = None
    else:
        out[prefix] = torch.as_tensor(tree).detach().cpu()
    return out


def _unflatten(flat: dict):
    # rebuild nested dicts first, then convert list-like nodes
    root: dict = {}
    for path, val in flat.items():
        parts = [p for p in path.split(_SEP) if p]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def convert(node):
        if not isinstance(node, dict):
            return node
        if "__type__" in node:
            typ = node.pop("__type__")
            items = [convert(node[str(i)]) for i in range(len(node))]
            return items if typ == "list" else tuple(items)
        return {k: convert(v) for k, v in node.items()}

    return convert(root)


def save_checkpoint(directory: str, step: int, tree: Any, *, keep: int = 3,
                    metadata: dict | None = None) -> str:
    """Atomically write checkpoint for ``step``; prune to the newest ``keep``."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    final = os.path.join(directory, f"ckpt_{step:010d}")
    tmp = final + f".tmp.{os.getpid()}.{int(time.time() * 1e6)}"
    os.makedirs(tmp)
    torch.save(flat, os.path.join(tmp, "tree.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "time": time.time(), **(metadata or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # commit point
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int):
    steps = sorted(list_checkpoints(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"ckpt_{s:010d}"),
                      ignore_errors=True)
    # clean stale tmp dirs from preempted writers
    for name in os.listdir(directory):
        if ".tmp." in name:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def list_checkpoints(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"ckpt_(\d{10})", name)
        if m and os.path.exists(os.path.join(directory, name, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = list_checkpoints(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, step: int | None = None):
    """Returns (step, tree) with CPU tensors; the caller moves them."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:010d}", "tree.pt")
    return step, _unflatten(torch.load(path, weights_only=True))
