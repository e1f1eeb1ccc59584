"""Paged KV-cache bookkeeping: block pool, prefix trie, copy-on-write.

The serving engine stores attention K/V in fixed-size *pages* (blocks of
``block_size`` token slots shared by all layers) instead of one dense
``[L, B, max_seq]`` region per slot.  This module is the pure-host side of
that subsystem — numpy/python bookkeeping only, no device arrays — so its
invariants are testable without touching jax:

  * ``BlockPool``   — refcounted allocator over a fixed set of page ids.
    Page 0 is reserved as the *null page*: inactive batch slots point at it
    so batched scatter/gather in the decode step never aliases live data.
  * prefix trie     — full prompt blocks are registered under a chained
    hash ``h_j = H(h_{j-1}, tokens[j*bs:(j+1)*bs])``; a later request with
    the same prompt prefix re-uses those pages (refcount++) and skips
    recomputing their K/V.  ``tokens`` here are the engine's per-position
    *key ids*: real token ids for text positions, negative
    content-digest-derived ids for embedding spans
    (repro_torch/serving/segments.key_ids) — so a repeated image hits the trie
    like repeated text, while media can never alias a vocab id.
  * LRU eviction    — a registered page whose refcount drops to zero is
    *not* freed: it parks in an LRU so future prefix hits still find it,
    and is evicted (trie entry dropped, page recycled) only when the pool
    runs dry.
  * copy-on-write   — a request may need to write into a page it shares
    with the trie or another request (e.g. recomputing the final prompt
    token of a fully-cached prompt).  ``ensure_writable`` hands back a
    private replacement page and tells the caller to copy the contents.
  * KV snapshots    — ``KVSnapshot`` is the portable, self-describing form
    of a request's KV state (host-resident page contents + int8 scale
    rows + prefix-trie chain hashes + geometry): the engine exports one to
    checkpoint/evacuate a live request, and a *foreign* engine adopts it
    straight into decode phase (``BlockPool.lookup_hashes`` +
    ``register_blocks`` re-register the prompt blocks in the receiving
    trie, so repeated prompts hit the destination's cache afterwards).

Device-side layout (owned by the engine): ``k_pages``/``v_pages`` are
``[L, num_pages, block_size, Hkv, Dh]`` and a per-slot block table maps
logical block ``j`` (token positions ``[j*bs, (j+1)*bs)``) to a page id.
With ``kv_dtype="int8"`` the pools are stored quantized (symmetric
per-row int8, repro_torch/kernels/quant.py) and fp32 scale tensors
``k_scales``/``v_scales`` ``[L, num_pages, block_size, Hkv]`` ride
alongside them.  The pool bookkeeping here is unchanged by precision —
pages are identified by id, and every device array (values *and* scales)
is indexed by that id, so copy-on-write, LRU eviction and prefix-trie
reuse carry the scales for free.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque

import numpy as np
import torch

NULL_PAGE = 0

# bytes per stored K/V element per precision, plus the per-row (per token
# position, per kv head) fp32 scale the int8 layout adds
KV_DTYPE_BYTES = {"bf16": 2, "int8": 1}
SCALE_ITEMSIZE = 4
# a KVSnapshot's host form: its leaves and their dtypes per precision
SNAPSHOT_FORMS = {"bf16": {"k_pages": torch.bfloat16,
                           "v_pages": torch.bfloat16},
                  "int8": {"k_pages": torch.int8, "v_pages": torch.int8,
                           "k_scales": torch.float32,
                           "v_scales": torch.float32}}


def ceil_blocks(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` positions (last may be partial).

    The one source of truth for block-capacity math — the engine's batch
    assembly (``max_blocks``, admission horizons) and the snapshot
    import path both use it, so their row/padding arithmetic can never
    drift apart."""
    return -(-int(n_tokens) // int(block_size))


def full_blocks(n_tokens: int, block_size: int) -> int:
    """Blocks *fully covered* by ``n_tokens`` positions — the only blocks
    the prefix trie may register (partial blocks are still writable)."""
    return int(n_tokens) // int(block_size)


def kv_token_bytes(n_layers: int, n_kv_heads: int, head_dim: int,
                   kv_dtype: str = "bf16") -> int:
    """Bytes one token position occupies across the K+V pools of all
    layers — the unit both the engine's ``kv_budget_bytes`` admission
    sizing and the kernel_bench int8-vs-bf16 rows are denominated in.
    int8 pays ``head_dim + 4`` bytes per head row (values + fp32 scale)
    against bf16's ``2 * head_dim``: a ``2*Dh / (Dh+4)`` reduction, e.g.
    1.94x at Dh=128."""
    if kv_dtype not in KV_DTYPE_BYTES:
        raise ValueError(f"kv_dtype must be one of {list(KV_DTYPE_BYTES)}, "
                         f"got {kv_dtype!r}")
    per_head = head_dim * KV_DTYPE_BYTES[kv_dtype]
    if kv_dtype == "int8":
        per_head += SCALE_ITEMSIZE
    return 2 * n_layers * n_kv_heads * per_head  # K + V


def kv_page_bytes(n_layers: int, n_kv_heads: int, head_dim: int,
                  block_size: int, kv_dtype: str = "bf16") -> int:
    """Bytes one page (all layers, K+V, scales included) occupies."""
    return kv_token_bytes(n_layers, n_kv_heads, head_dim,
                          kv_dtype) * block_size


class OutOfPagesError(RuntimeError):
    """Raised when the pool is exhausted and nothing is evictable."""


class BlockPool:
    """Refcounted page allocator with prefix registry and LRU eviction."""

    def __init__(self, num_pages: int, block_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_pages = num_pages
        self.block_size = block_size
        self.ref = np.zeros(num_pages, np.int64)
        # page 0 reserved: never allocated, never written by live requests
        self.free_list: deque[int] = deque(range(1, num_pages))
        self.lru: "OrderedDict[int, bool]" = OrderedDict()  # evictable pages
        self.page_hash: dict[int, int] = {}  # page -> chain hash
        self.hash_page: dict[int, int] = {}  # chain hash -> page
        # stats
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.cow_copies = 0

    # ------------------------------------------------------------ allocation
    def num_free(self) -> int:
        """Pages allocatable right now (free + evictable)."""
        return len(self.free_list) + len(self.lru)

    def pages_in_use(self) -> int:
        return int((self.ref > 0).sum())

    def alloc(self) -> int:
        """Grab a private page (ref=1), evicting a cached prefix if needed."""
        if self.free_list:
            page = self.free_list.popleft()
        elif self.lru:
            page, _ = self.lru.popitem(last=False)  # least recently used
            self._drop_registration(page)
            self.evictions += 1
        else:
            raise OutOfPagesError(
                f"all {self.num_pages - 1} pages referenced by live requests")
        assert self.ref[page] == 0
        self.ref[page] = 1
        return page

    def retain(self, page: int):
        """A new request starts sharing ``page``."""
        if self.ref[page] == 0:
            self.lru.pop(page, None)  # back in live use
        self.ref[page] += 1

    def release(self, page: int):
        """Drop one reference; unregistered pages go back to the free list,
        registered ones park in the LRU (data kept for future prefix hits)."""
        if self.ref[page] <= 0:
            raise ValueError(f"release of unreferenced page {page}")
        self.ref[page] -= 1
        if self.ref[page] == 0:
            if page in self.page_hash:
                self.lru[page] = True
                self.lru.move_to_end(page)
            else:
                self.free_list.append(page)

    def ensure_writable(self, page: int) -> tuple[int, bool]:
        """Copy-on-write gate for a page about to receive K/V writes.

        Returns ``(page, False)`` when the caller holds the only reference
        and the page is not a registered prefix, else allocates a private
        replacement and returns ``(new_page, True)`` — the caller must copy
        the device contents ``old -> new`` and then ``release(old)``.
        """
        if self.ref[page] == 1 and page not in self.page_hash:
            return page, False
        new = self.alloc()
        self.cow_copies += 1
        return new, True

    # ---------------------------------------------------------- prefix trie
    @staticmethod
    def chain_hash(parent: int | None, block_tokens) -> int:
        return hash((parent, bytes(np.asarray(block_tokens, np.int64).data)))

    @classmethod
    def chain_hashes(cls, tokens, block_size: int) -> list[int]:
        """Chain hash of every *full* block of ``tokens`` — the trie keys a
        registered prompt lives under.  A ``KVSnapshot`` carries these, so
        a foreign pool can look up / re-register the snapshot's prompt
        blocks without recomputing token bytes."""
        tokens = np.asarray(tokens)
        h: int | None = None
        out: list[int] = []
        for j in range(full_blocks(len(tokens), block_size)):
            h = cls.chain_hash(h, tokens[j * block_size:(j + 1) * block_size])
            out.append(h)
        return out

    def peek_prefix(self, tokens) -> list[int]:
        """Pages of the cached prefix, without side effects.

        Unlike ``lookup_prefix`` this takes no references and records no
        hit/miss stats — use it for admission-control checks that may be
        retried many times before the real lookup.
        """
        return self.peek_hashes(self.chain_hashes(tokens, self.block_size))

    def peek_hashes(self, hashes: "list[int]") -> list[int]:
        """Pages resident under a leading run of precomputed chain hashes,
        without side effects — ``peek_prefix`` for callers that already
        hold the hashes (snapshot import admission)."""
        pages: list[int] = []
        for h in hashes:
            page = self.hash_page.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def lookup_prefix(self, tokens) -> tuple[list[int], int]:
        """Longest cached block-aligned prefix of ``tokens``.

        Returns ``(pages, n_tokens)``; every returned page has been
        ``retain``-ed for the caller (caller owns one reference each).
        """
        pages = self.lookup_hashes(self.chain_hashes(tokens,
                                                     self.block_size))
        return pages, len(pages) * self.block_size

    def lookup_hashes(self, hashes: "list[int]") -> list[int]:
        """``lookup_prefix`` over precomputed chain hashes: the leading
        resident run is ``retain``-ed for the caller (one reference each)
        and hit/miss stats are recorded."""
        pages: list[int] = []
        for h in hashes:
            page = self.hash_page.get(h)
            if page is None:
                self.misses += 1
                break
            self.hits += 1
            self.retain(page)
            pages.append(page)
        return pages

    def register_prefix(self, tokens, pages: list[int]):
        """Publish the full prompt blocks of a request into the trie.

        ``pages[j]`` holds K/V for ``tokens[j*bs:(j+1)*bs]``; only blocks
        fully covered by prompt tokens may be passed (they are immutable for
        the rest of the request's life, so sharing is safe).  Pages already
        registered (prefix hits) are no-ops; a hash collision with a
        different live page keeps the first registration.
        """
        hashes = self.chain_hashes(tokens, self.block_size)
        self.register_blocks(hashes[:len(pages)], pages)

    def register_blocks(self, hashes: "list[int]", pages: list[int]):
        """``register_prefix`` over precomputed chain hashes — the adoption
        path of an imported ``KVSnapshot`` re-registers its prompt blocks
        under the hashes the snapshot carries, so the receiving engine's
        trie serves repeated prompts from the migrated pages."""
        for h, page in zip(hashes, pages):
            if h in self.hash_page:
                continue  # already published (e.g. this request's own hit)
            if page in self.page_hash:
                continue  # page already published under another chain
            self.hash_page[h] = page
            self.page_hash[page] = h

    def _drop_registration(self, page: int):
        h = self.page_hash.pop(page, None)
        if h is not None:
            self.hash_page.pop(h, None)

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "block_size": self.block_size,
            "pages_in_use": self.pages_in_use(),
            "pages_cached": len(self.lru),
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "evictions": self.evictions,
            "cow_copies": self.cow_copies,
        }


@dataclasses.dataclass
class BlockTable:
    """Logical-block -> page mapping for one request/slot."""

    pool: BlockPool
    pages: list[int] = dataclasses.field(default_factory=list)

    def num_tokens_capacity(self) -> int:
        return len(self.pages) * self.pool.block_size

    def ensure_capacity(self, n_tokens: int):
        """Allocate fresh pages until ``n_tokens`` positions are addressable."""
        while len(self.pages) < ceil_blocks(n_tokens, self.pool.block_size):
            self.pages.append(self.pool.alloc())

    def page_of(self, position: int) -> int:
        return self.pages[position // self.pool.block_size]

    def rows_for(self, positions) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized (page_ids, offsets) for an array of logical positions
        — the host side of the K/V scatter path used by (chunked) prefill."""
        positions = np.asarray(positions)
        bs = self.pool.block_size
        pages = np.asarray(self.pages, np.int32)[positions // bs]
        return pages, (positions % bs).astype(np.int32)

    def slot_of(self, position: int) -> tuple[int, int]:
        return self.page_of(position), position % self.pool.block_size

    def as_row(self, max_blocks: int) -> np.ndarray:
        row = np.full(max_blocks, -1, np.int32)
        row[:len(self.pages)] = self.pages
        return row

    def free(self):
        for page in self.pages:
            self.pool.release(page)
        self.pages = []


@dataclasses.dataclass
class KVSnapshot:
    """Portable, self-describing KV state of one (partially decoded)
    request — the unit of cross-engine migration.

    The engine exports a snapshot by gathering the request's contiguous
    logical block range to host tensors (refcounts held during the gather;
    the snapshot is a *copy*, so source-side eviction or page recycling
    can never corrupt it), and a foreign engine adopts it straight into
    decode phase: resident prompt blocks are reused from the receiving
    trie, missing blocks are scattered into freshly allocated pages
    (precision-converted if the pools disagree), and the prompt blocks are
    re-registered under the carried chain hashes.

    ``leaves`` holds the page contents in the source pool's storage form,
    as CPU torch tensors (numpy has no bfloat16; bf16 rows, or int8 rows
    and fp32 scales, bit for bit), keyed like the device cache
    (``k_pages``/``v_pages`` ``[L, NB, bs, Hkv, Dh]``, plus
    ``k_scales``/``v_scales`` ``[L, NB, bs, Hkv]`` for int8) with the
    page axis in *logical block order* — block ``j`` of ``tokens`` lives
    at index ``j``, so the implied block-table row is ``arange(NB)`` and
    the importer never needs the source's page ids (``src_pages`` rides
    along for provenance only).
    """

    tokens: np.ndarray  # [n_ctx] int64 key ids of every written position
    n_prompt: int  # leading prompt key ids among ``tokens``
    block_size: int
    kv_dtype: str  # storage form of ``leaves`` ("bf16" | "int8")
    geometry: "tuple[int, int, int]"  # (n_layers, n_kv_heads, head_dim)
    leaves: "dict[str, torch.Tensor]"
    prefix_hashes: "list[int]"  # chain hash per full *prompt* block
    src_pages: "list[int]" = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int64)
        L, hkv, dh = self.geometry
        want = (L, self.num_pages, self.block_size, hkv, dh)
        got = tuple(self.leaves["k_pages"].shape)
        if got != want:
            raise ValueError(f"KVSnapshot: k_pages shape {got} does not "
                             f"match geometry/context {want}")
        forms = SNAPSHOT_FORMS.get(self.kv_dtype)
        if forms is None:
            raise ValueError(f"KVSnapshot: kv_dtype {self.kv_dtype!r}")
        got = {n: (t.dtype, t.device.type) if isinstance(t, torch.Tensor)
               else type(t).__name__ for n, t in self.leaves.items()}
        if got != {n: (dt, "cpu") for n, dt in forms.items()}:
            raise ValueError(f"KVSnapshot: {self.kv_dtype} leaves must be "
                             f"CPU tensors {forms}, got {got}")
        if len(self.prefix_hashes) != full_blocks(self.n_prompt,
                                                  self.block_size):
            raise ValueError(
                f"KVSnapshot: {len(self.prefix_hashes)} prefix hashes for "
                f"{full_blocks(self.n_prompt, self.block_size)} full prompt "
                "blocks")

    @property
    def num_tokens(self) -> int:
        """Context positions the snapshot covers (prompt + generated)."""
        return len(self.tokens)

    @property
    def num_pages(self) -> int:
        return ceil_blocks(len(self.tokens), self.block_size)

    def page_bytes(self) -> int:
        """Bytes per page in the snapshot's *own* storage form.  Migration
        pricing instead uses the destination engine's ``page_bytes()`` —
        the importer converts precision on adoption, so only
        destination-form bytes need to cross a link."""
        L, hkv, dh = self.geometry
        return kv_page_bytes(L, hkv, dh, self.block_size, self.kv_dtype)

    def nbytes(self) -> int:
        return self.num_pages * self.page_bytes()
