"""Typed prompt segments: the modality-aware request representation.

A multimodal prompt is an ordered list of *segments*, each occupying a
contiguous span of KV-cache positions:

  * ``TextSegment``  — ordinary token ids; positions are embedded through
    the LM's token table inside the jitted prefill entry point.
  * ``EmbedSegment`` — precomputed embedding vectors (image patches from
    the conv-patchify encoder, audio frames, ...) injected *as-is* at
    their positions; the LM never sees token ids for them.

Everything downstream of the embedding boundary (attention, KV pages,
decode) is modality-agnostic, so the serving stack only needs two things
from a segment list:

  * ``key_ids``        — one int64 per position, used everywhere token ids
    were used for *bookkeeping*: prompt length, bucket shapes and — most
    importantly — the paged prefix-cache trie
    (repro_torch/serving/kv_cache.py).
    Text positions keep their token id; embedding positions get a negative
    id derived from the segment's content ``digest`` and the offset within
    the segment, so two requests carrying the *same* image produce the
    same chain hashes and hit each other's prefix blocks, while a
    different image (or a different compression setting) can never collide
    with a real token id.
  * ``dense_features`` — the ``[T, d]`` feature rows + ``[T]`` bool mask
    handed to the model entry points (``lm.embed_inputs`` selects between
    the token-table lookup and the injected row per position).

Digests are content hashes of the *feature bytes* (`feature_digest`): two
media inputs share KV pages exactly when they would produce identical
embeddings, which is the only correct notion of "same image" for cache
reuse (it folds in the encoder weights and the keep-top-k setting).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

# embedding-position key ids live in [-2**62, -1]: disjoint from every
# valid vocab id, so a text block can never alias a media block in the
# prefix trie's chain hash
_KEY_SPACE = 1 << 62
_KEY_MIX = 0x9E3779B97F4A7C15  # Fibonacci hashing multiplier


def feature_digest(features: np.ndarray) -> int:
    """Stable content hash of an embedding span (any dtype/shape)."""
    arr = np.ascontiguousarray(np.asarray(features, np.float32))
    h = hashlib.blake2b(arr.tobytes(), digest_size=8)
    h.update(str(arr.shape).encode())
    return int.from_bytes(h.digest(), "little")


@dataclasses.dataclass(frozen=True)
class TextSegment:
    """A span of ordinary token ids."""

    tokens: np.ndarray

    def __len__(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass(frozen=True)
class EmbedSegment:
    """A span of precomputed embedding vectors (one per position).

    ``features`` is ``[n, d_model]``; ``modality`` tags the span for the
    cost model's per-modality payload accounting; ``raw_bytes`` /
    ``feature_bytes`` describe what shipping this media costs over the
    uplink in each form (raw media vs. encoded features) — the split-point
    decision (sim/cost_model.best_split) compares exactly these.
    ``digest`` defaults to a content hash of the features.
    """

    features: np.ndarray
    modality: str = "image"
    raw_bytes: float = 0.0
    feature_bytes: float = 0.0
    digest: int | None = None

    def __len__(self) -> int:
        return len(self.features)

    def content_digest(self) -> int:
        return self.digest if self.digest is not None \
            else feature_digest(self.features)


Segment = TextSegment | EmbedSegment


def total_len(segments: "list[Segment]") -> int:
    return sum(len(s) for s in segments)


def key_ids(segments: "list[Segment]") -> np.ndarray:
    """Per-position int64 bookkeeping ids (prefix-trie hash inputs).

    Text positions carry their token id; embedding positions carry
    ``-(1 + mix(digest, offset))`` — always negative, deterministic in the
    segment content, distinct across offsets within a span.
    """
    out = []
    for seg in segments:
        if isinstance(seg, TextSegment):
            out.append(np.asarray(seg.tokens, np.int64))
        else:
            g = seg.content_digest()
            vals = [-(1 + ((g + j * _KEY_MIX) % _KEY_SPACE))
                    for j in range(len(seg))]
            out.append(np.asarray(vals, np.int64))
    if not out:
        return np.zeros(0, np.int64)
    return np.concatenate(out)


def dense_features(segments: "list[Segment]", d_model: int
                   ) -> "tuple[np.ndarray, np.ndarray]":
    """(features [T, d_model] float32, embed_mask [T] bool) for the model
    entry points; text rows are zero and masked out."""
    T = total_len(segments)
    feats = np.zeros((T, d_model), np.float32)
    mask = np.zeros(T, bool)
    pos = 0
    for seg in segments:
        n = len(seg)
        if isinstance(seg, EmbedSegment):
            f = np.asarray(seg.features, np.float32)
            if f.ndim != 2 or f.shape[1] != d_model:
                raise ValueError(
                    f"EmbedSegment features {f.shape} do not match "
                    f"d_model={d_model}")
            feats[pos:pos + n] = f
            mask[pos:pos + n] = True
        pos += n
    return feats, mask


def media_segments(segments: "list[Segment]") -> "list[EmbedSegment]":
    return [s for s in segments if isinstance(s, EmbedSegment)]
