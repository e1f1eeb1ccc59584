"""Synthetic MMBench-like multimodal task set.

MMBench itself (3,377 image+text choice questions, 20 task categories) is not
available offline; we generate a statistically matched stand-in: per-category
difficulty distributions, prompt-length distributions, and procedural images
whose statistics (edges, texture, entropy) vary with category and difficulty.
Each task additionally carries a media ``modality`` (image / audio / text-
only, category-biased) and a matching procedural media generator
(``image`` / ``audio``), so the multimodal serving benchmarks can replay
traces where real media segments travel through the request path.
Seeded and fully deterministic.

A copy of ``repro/data/taskgen.py`` (numpy only), so that the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

CATEGORIES = [
    "action_recognition", "attribute_comparison", "attribute_recognition",
    "celebrity_recognition", "function_reasoning", "future_prediction",
    "identity_reasoning", "image_emotion", "image_quality", "image_scene",
    "image_style", "image_topic", "nature_relation", "object_localization",
    "ocr", "physical_property", "physical_relation", "social_relation",
    "spatial_relationship", "structuralized_image_text",
]

N_TASKS = 3377  # match MMBench

# per-task media modality: what travels with the text prompt.  MMBench is
# image+text; the multimodal serving traces add an audio share so the
# split-point benchmarks exercise more than one payload class.
MODALITIES = ["text", "image", "audio"]


@dataclasses.dataclass
class TaskSet:
    n: int
    category: np.ndarray  # [n] int
    difficulty: np.ndarray  # [n] float in (0,1)
    text_len: np.ndarray  # [n] int (prompt tokens)
    image_entropy: np.ndarray  # [n] float
    seed: int
    modality: np.ndarray | None = None  # [n] int into MODALITIES

    def text_tokens(self, idx: int, max_len: int, vocab: int) -> np.ndarray:
        """Deterministic per-task DistilBERT-style token ids + mask."""
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        L = min(int(self.text_len[idx]), max_len)
        # category-biased token distribution (zipf-ish)
        base = 1000 + int(self.category[idx]) * 700
        ids = base + rng.zipf(1.6, size=L) % (vocab - base - 1)
        out = np.zeros(max_len, np.int32)
        out[:L] = np.minimum(ids, vocab - 1)
        mask = np.zeros(max_len, np.int32)
        mask[:L] = 1
        return out, mask

    def image(self, idx: int, size: int) -> np.ndarray:
        """Procedural [size,size,3] image in [0,1]: gradient + blobs + noise,
        with edge density tied to category and noise to difficulty."""
        rng = np.random.default_rng(self.seed * 2_000_003 + idx)
        cat = int(self.category[idx])
        dif = float(self.difficulty[idx])
        yy, xx = np.mgrid[0:size, 0:size] / size
        img = np.stack([
            0.5 + 0.5 * np.sin(2 * np.pi * (xx * (1 + cat % 5))),
            0.5 + 0.5 * np.cos(2 * np.pi * (yy * (1 + cat % 3))),
            np.full_like(xx, 0.3 + 0.02 * cat),
        ], -1)
        for _ in range(2 + cat % 4):  # blobs = objects
            cx, cy, r = rng.random(), rng.random(), 0.08 + 0.2 * rng.random()
            m = ((xx - cx) ** 2 + (yy - cy) ** 2) < r * r
            img[m] = rng.random(3)
        img += rng.normal(0, 0.05 + 0.25 * dif, img.shape)  # difficulty noise
        return np.clip(img, 0, 1).astype(np.float32)

    def audio(self, idx: int, n_frames: int, n_mel: int = 16) -> np.ndarray:
        """Procedural [n_frames, n_mel] log-mel-like frames: a category-
        pitched harmonic ramp + difficulty-scaled noise (the audio analog
        of ``image``).  Seeded and fully deterministic."""
        rng = np.random.default_rng(self.seed * 3_000_017 + idx)
        cat = int(self.category[idx])
        dif = float(self.difficulty[idx])
        t = np.arange(n_frames)[:, None] / max(n_frames, 1)
        m = np.arange(n_mel)[None, :] / max(n_mel, 1)
        frames = (0.5 + 0.5 * np.sin(2 * np.pi * ((1 + cat % 5) * t
                                                  + (1 + cat % 3) * m))
                  ) * np.exp(-2.0 * m)
        frames += rng.normal(0, 0.05 + 0.25 * dif, frames.shape)
        return frames.astype(np.float32)

    def modality_name(self, idx: int) -> str:
        if self.modality is None:
            return "image"  # MMBench default: every task carries an image
        return MODALITIES[int(self.modality[idx])]

    def images(self, idxs, size: int) -> np.ndarray:
        return np.stack([self.image(int(i), size) for i in idxs])

    def texts(self, idxs, max_len: int, vocab: int):
        toks, masks = zip(*[self.text_tokens(int(i), max_len, vocab)
                            for i in idxs])
        return np.stack(toks), np.stack(masks)


def make_taskset(n: int = N_TASKS, seed: int = 0) -> TaskSet:
    rng = np.random.default_rng(seed)
    category = rng.integers(0, len(CATEGORIES), n)
    # per-category base difficulty + per-task Beta spread
    cat_base = rng.uniform(0.25, 0.75, len(CATEGORIES))
    difficulty = np.clip(
        cat_base[category] + 0.35 * (rng.beta(2, 2, n) - 0.5), 0.02, 0.98)
    text_len = np.clip(rng.lognormal(3.6, 0.5, n), 8, 256).astype(np.int64)
    image_entropy = 0.3 + 0.6 * difficulty + rng.normal(0, 0.05, n)
    # media modality, category-biased: harder (visual-heavy) categories
    # are mostly image-bound, the rest less so; both keep a 15% audio
    # share and the remainder is text-only
    p_img = np.where(cat_base[category] > 0.5, 0.8, 0.6)
    u = rng.random(n)
    modality = np.where(u < p_img, MODALITIES.index("image"),
                        np.where(u < p_img + 0.15,
                                 MODALITIES.index("audio"),
                                 MODALITIES.index("text")))
    return TaskSet(n, category, difficulty, text_len, image_entropy, seed,
                   modality=modality.astype(np.int64))


def splits(n: int, seed: int = 0, ratios=(0.8, 0.1, 0.1)):
    """train/val/test index split (paper: 8:1:1)."""
    rng = np.random.default_rng(seed + 99)
    order = rng.permutation(n)
    n_tr = int(ratios[0] * n)
    n_va = int(ratios[1] * n)
    return order[:n_tr], order[n_tr:n_tr + n_va], order[n_tr + n_va:]


# --------------------------------------------------------- arrival traces
# Request *timing* for the scale-out replay (benchmarks/fig13_scaleout.py):
# the taskset says what the requests are, these say when they arrive.


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0) -> np.ndarray:
    """``n`` arrival times (seconds, sorted, starting after 0) of a
    homogeneous Poisson process with mean ``rate_per_s`` requests/s —
    i.i.d. exponential inter-arrival gaps."""
    if rate_per_s <= 0:
        raise ValueError(f"rate_per_s must be positive, got {rate_per_s}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_per_s, n))


def diurnal_arrivals(n: int, rate_per_s: float, period_s: float,
                     seed: int = 0, depth: float = 0.8) -> np.ndarray:
    """``n`` arrivals of an inhomogeneous Poisson process whose rate
    swings sinusoidally around ``rate_per_s`` — the classic diurnal
    serving load, compressed to ``period_s`` so a replay sees whole
    peak/trough cycles.  ``depth`` in [0, 1) scales the swing:
    ``rate(t) = rate_per_s * (1 + depth * sin(2 pi t / period_s))``.
    Generated by thinning (Lewis & Shedler): candidates at the peak rate,
    kept with probability rate(t)/peak."""
    if not 0.0 <= depth < 1.0:
        raise ValueError(f"depth must be in [0, 1), got {depth}")
    if rate_per_s <= 0 or period_s <= 0:
        raise ValueError("rate_per_s and period_s must be positive")
    rng = np.random.default_rng(seed)
    peak = rate_per_s * (1.0 + depth)
    out = np.empty(n)
    t, i = 0.0, 0
    while i < n:
        t += rng.exponential(1.0 / peak)
        rate = rate_per_s * (1.0 + depth * np.sin(2.0 * np.pi * t / period_s))
        if rng.random() * peak < rate:
            out[i] = t
            i += 1
    return out


def session_ids(n: int, n_sessions: int, seed: int = 0,
                concentration: float = 1.2) -> np.ndarray:
    """Assign each of ``n`` requests to one of ``n_sessions``
    conversations (Zipf-ish popularity via a Dirichlet draw): requests in
    a session share a prompt prefix, which is what prefix-affinity
    routing and the engines' prefix caches exploit."""
    if n_sessions < 1:
        raise ValueError(f"n_sessions must be >= 1, got {n_sessions}")
    rng = np.random.default_rng(seed + 7)
    weights = rng.dirichlet(np.full(n_sessions, concentration))
    return rng.choice(n_sessions, size=n, p=weights).astype(np.int64)
