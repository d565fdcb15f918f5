"""Paged KV cache: page pools, block tables, prefix reuse (the port of
``repro.serving.kv_cache``).

* **page pool** — one ``[n_pages, KV, page_size, hd]`` tensor pair per layer
  (int8 values + one f32 scale per token per KV head when ``cfg.kv_bits ==
  8``; packed uint8 nibbles ``[..., hd/2]`` + the same scales when
  ``cfg.kv_bits == 4``; or float32). Page 0 is the reserved *trash* page:
  inactive decode lanes and bucket padding write there, and nothing ever
  reads it.
* **block tables** — ``[max_batch, max_pages_per_seq]`` int32 mapping lane
  position ``p`` to page ``table[lane, p // page_size]``, slot ``p %
  page_size``; retired lanes point every entry at the trash page.
* **PageAllocator** — host-side refcounted allocation with a chained-hash
  prefix cache (the reference's code, unchanged).

Pools are written in place (prefill's page writes here, decode's appends in
the attention kernel), where the reference returned new arrays.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.paged_attention import (
    KV4_QMAX, pack_int4, pool_kind, quant_rows, unpack_int4)

__all__ = [
    "TRASH_PAGE",
    "pages_needed",
    "kv_bytes_per_token",
    "init_page_pool",
    "init_paged_cache",
    "write_prompt_pages",
    "gather_prefix",
    "rewind_positions",
    "PageAllocator",
]

TRASH_PAGE = 0  # reserved: written by inactive lanes / padding, never read


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages required to hold ``n_tokens`` cache rows."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // page_size)


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """Pool bytes one cache row costs across all layers (values + scales)."""
    if cfg.kv_bits is None:
        per_row = 2 * cfg.hd * 4  # float32 k + v, no scales
    else:
        per_row = 2 * (cfg.hd * cfg.kv_bits // 8) + 2 * 4
    return cfg.n_layers * cfg.n_kv_heads * per_row


# ---------------------------------------------------------------------------
# Device-side pool ops


def init_page_pool(cfg: ModelConfig, n_pages: int, page_size: int, *, device) -> Dict:
    """One layer's pool: ``[n_pages, KV, page_size, hd]`` (+ scales if int8;
    ``[..., hd/2]`` uint8 nibbles + scales if int4)."""
    shape = (n_pages, cfg.n_kv_heads, page_size, cfg.hd)
    if cfg.kv_bits is not None:
        if cfg.kv_bits not in (4, 8):
            raise ValueError(f"kv_bits must be 4 or 8 (or None), got {cfg.kv_bits}")
        dtype = torch.int8
        if cfg.kv_bits == 4:
            # Split-half packing (pack_int4): byte j holds channels j and
            # j + hd/2. The uint8 dtype is the tier discriminator.
            if cfg.hd % 2:
                raise ValueError(f"kv_bits=4 needs an even head dim, got {cfg.hd}")
            shape, dtype = shape[:3] + (cfg.hd // 2,), torch.uint8
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=torch.float32, device=device),
        "v": torch.zeros(shape, dtype=torch.float32, device=device),
    }


def init_paged_cache(
    cfg: ModelConfig, batch: int, n_pages: int, page_size: int,
    max_pages_per_seq: int, *, device,
) -> Dict:
    """Engine cache tree: ``layers[i]["attn"]`` is layer i's page pool;
    ``table`` and ``pos`` are shared across layers."""
    if cfg.block not in ("dense", "moe"):
        raise NotImplementedError(
            f"paged KV cache: dense and MoE archs only, got {cfg.block} (SSM and hybrid "
            "models serve on the unpaged engine)")
    return {
        "layers": [
            {"attn": init_page_pool(cfg, n_pages, page_size, device=device)}
            for _ in range(cfg.n_layers)
        ],
        "table": torch.zeros((batch, max_pages_per_seq), dtype=torch.int32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def write_prompt_pages(pool: Dict, k, v, page_ids) -> Dict:
    """Write a prefilled prompt's K/V into its pages, in place.

    k/v: ``[1, S, KV, hd]`` (post-RoPE, ``S % page_size == 0``); page_ids:
    ``[S // page_size]`` — the sequence's pages in order, padded with the
    trash page past the allocation. Returns ``pool``.
    """
    ps = pool["k"].shape[2]
    s, n_kv, hd = k.shape[1:]
    nb = s // ps
    ids = page_ids.long()

    def paged(x):  # [1, S, KV, hd] -> [nb, KV, ps, hd]
        return x[0].reshape(nb, ps, n_kv, hd).movedim(2, 1)

    k_p, v_p = paged(k), paged(v)
    kind = pool_kind(pool)
    if kind != "float":
        # The decode append's grid: quant_rows at qmax 127 (int8) or 7
        # (int4, nibble-packed).
        qm = 127.0 if kind == "int8" else KV4_QMAX
        k_q, k_s = quant_rows(k_p, qm)
        v_q, v_s = quant_rows(v_p, qm)
        if kind == "int4":
            k_q, v_q = pack_int4(k_q), pack_int4(v_q)
        pool["k"][ids] = k_q
        pool["v"][ids] = v_q
        pool["k_scale"][ids] = k_s
        pool["v_scale"][ids] = v_s
    else:
        pool["k"][ids] = k_p.to(pool["k"].dtype)
        pool["v"][ids] = v_p.to(pool["v"].dtype)
    return pool


def gather_prefix(pool: Dict, prefix_ids) -> Tuple:
    """Dequantized K/V of a shared prompt prefix: ``[1, n_hit, KV, hd]`` f32
    each, the ``kv_prefix`` layout prefill attention concatenates."""
    n_kv, ps, hd = pool["k"].shape[1:]
    n_hit = prefix_ids.shape[0]
    ids = prefix_ids.long()
    packed = pool["k"].dtype == torch.uint8
    if packed:
        hd *= 2  # two nibbles a byte

    def flat(vals, scale):  # [H, KV, ps, hd] -> [1, H*ps, KV, hd]
        if packed:
            vals = unpack_int4(vals)
        x = vals.to(torch.float32)
        if scale is not None:
            x = x * scale[..., None]
        return x.movedim(1, 2).reshape(1, n_hit * ps, n_kv, hd)

    quant = "k_scale" in pool
    k = flat(pool["k"][ids], pool["k_scale"][ids] if quant else None)
    v = flat(pool["v"][ids], pool["v_scale"][ids] if quant else None)
    return k, v


def rewind_positions(pos_vec: torch.Tensor, new_pos) -> torch.Tensor:
    """Roll the per-lane position vector back to the committed positions
    (``new_pos``, host ints), as int32 on ``pos_vec``'s device.

    The paged rollback invariant: a speculative verify writes K/V for every
    proposed position, but only positions ``< pos`` are visible to the
    causal mask, so rolling back a rejected tail is just this rewind. The
    stale rows past the committed position are overwritten in place when
    decode reaches those positions again; prompt pages (below the committed
    prefix) are never touched, so the prefix cache stays consistent.
    """
    out = torch.as_tensor(np.asarray(new_pos, np.int32), device=pos_vec.device)
    return out.reshape(pos_vec.shape)


# ---------------------------------------------------------------------------
# Host-side allocation + prefix cache (the reference's PageAllocator)


class PageAllocator:
    """Refcounted page allocator with a content-addressed prefix cache.

    Pages move between three states:

    * **free** — unallocated, on the free list;
    * **referenced** — owned by >= 1 live sequence (``_ref[pid] >= 1``);
    * **cached** — refcount dropped to zero but the page holds a registered
      prompt prefix; it stays hit-able in LRU order and is evicted (back to
      a fresh allocation) only under pool pressure.

    Admission control asks :meth:`available` (free + evictable-cached) before
    admitting; page 0 (the trash page) is never handed out.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the reserved trash page)")
        self.page_size = page_size
        self.n_pages = n_pages
        self.capacity = n_pages - 1  # trash page excluded
        self._free = deque(range(1, n_pages))
        self._ref: Dict[int, int] = {}
        self._key_of: Dict[int, bytes] = {}  # registered pid -> chain key
        self._page_of: Dict[bytes, int] = {}  # chain key -> pid
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # cached, ref==0
        self.peak_in_use = 0
        # Prefix-cache stats are counted by the caller (note_prefix_stats),
        # once per *admitted* request — a failed-admission retry loop calling
        # match_prefix every engine step must not inflate the hit rate.
        self.prefix_hit_pages = 0
        self.prefix_lookup_pages = 0

    # -- state ------------------------------------------------------------

    def in_use(self) -> int:
        return len(self._ref)

    def available(self) -> int:
        return len(self._free) + len(self._lru)

    def cached_pages(self) -> int:
        return len(self._lru)

    def hit_rate(self) -> float:
        if not self.prefix_lookup_pages:
            return 0.0
        return self.prefix_hit_pages / self.prefix_lookup_pages

    def _note_peak(self) -> None:
        if len(self._ref) > self.peak_in_use:
            self.peak_in_use = len(self._ref)

    # -- alloc/free --------------------------------------------------------

    def _evict_one(self) -> int:
        pid, _ = self._lru.popitem(last=False)  # oldest cached prefix first
        del self._page_of[self._key_of.pop(pid)]
        return pid

    def alloc(self, n: int) -> List[int]:
        if self.available() < n:
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {self.available()} "
                f"(capacity {self.capacity})"
            )
        out = []
        for _ in range(n):
            pid = self._free.popleft() if self._free else self._evict_one()
            self._ref[pid] = 1
            out.append(pid)
        self._note_peak()
        return out

    def retain(self, pid: int) -> None:
        if pid in self._ref:
            self._ref[pid] += 1
        else:  # cached page revived by a prefix hit
            del self._lru[pid]
            self._ref[pid] = 1
        self._note_peak()

    def release(self, ids: Sequence[int]) -> None:
        for pid in ids:
            r = self._ref[pid] - 1
            if r:
                self._ref[pid] = r
                continue
            del self._ref[pid]
            if pid in self._key_of:
                self._lru[pid] = None  # keep hit-able until evicted
            else:
                self._free.append(pid)

    def truncate(self, pages: List[int], keep_tokens: int) -> List[int]:
        """Page-aware rollback: release the tail of a lane's ``pages`` not
        needed to hold ``keep_tokens`` committed cache rows, returning the
        kept prefix. ``keep_tokens=0`` is retirement (release everything).

        Prefix-cache consistency: a released page that holds a registered
        prompt prefix drops to the LRU (still hit-able, evicted only under
        pool pressure) exactly like any other release — truncation can never
        orphan or double-free a shared prefix page, because shared prompt
        pages sit at the *front* of a lane's page list (positions below the
        committed prefix) and a commit point can only move past them.
        """
        keep = pages_needed(keep_tokens, self.page_size)
        if keep >= len(pages):
            return list(pages)
        self.release(pages[keep:])
        return list(pages[:keep])

    # -- prefix cache ------------------------------------------------------

    def chain_keys(self, tokens: Sequence[int], n_blocks: int) -> List[bytes]:
        """Content keys of the first ``n_blocks`` full pages: each key hashes
        its block's tokens chained on the previous key, so a key identifies
        the whole prefix up to and including its page."""
        keys = []
        h = b""
        for j in range(n_blocks):
            blk = np.asarray(
                tokens[j * self.page_size : (j + 1) * self.page_size], np.int64
            ).tobytes()
            h = hashlib.sha256(h + blk).digest()
            keys.append(h)
        return keys

    def match_prefix(
        self, tokens: Sequence[int], max_pages: int
    ) -> Tuple[List[int], List[bytes]]:
        """Longest cached prefix of ``tokens``, capped at ``max_pages`` pages.

        Returns ``(hit page ids — already retained, chain keys for *all*
        full pages)``; the caller registers the keys of the pages it writes
        and books stats via :meth:`note_prefix_stats` once it commits.
        """
        full = len(tokens) // self.page_size
        keys = self.chain_keys(tokens, full)
        hits: List[int] = []
        for j in range(min(max_pages, full)):
            pid = self._page_of.get(keys[j])
            if pid is None:
                break
            self.retain(pid)
            hits.append(pid)
        return hits, keys

    def note_prefix_stats(self, hit_pages: int, lookup_pages: int) -> None:
        """Book one admitted request's prefix-cache outcome."""
        self.prefix_hit_pages += hit_pages
        self.prefix_lookup_pages += lookup_pages

    def register(self, key: bytes, pid: int) -> None:
        """Publish a freshly written full prompt page. First writer wins:
        two cold identical prompts admitted back-to-back both write their own
        pages; only the first registration is kept."""
        if key in self._page_of or pid in self._key_of:
            return
        self._page_of[key] = pid
        self._key_of[pid] = key
