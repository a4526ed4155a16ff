"""Paged KV-cache block pool (vLLM-style) — counterpart of
``repro/serve/pool.py`` without tensor-parallel placement.

Every slot's K/V live in fixed-size pages; a sequence owns
``ceil(len/ps)`` pages, allocated and freed in O(1) from a free list, and
the serving steps route through a per-slot page table.  Page modes come
from :mod:`repro_torch.serve.kvq`: fp pages in ``dtype``, int8 pages
with per-(position, head) f32 scales, or int4 MUXQ'd nibble pages (pass
the artifact's ``kv_calib`` section for the calibrated redistribution;
uncalibrated int4 is plain symmetric int4).

Layout (``L`` = attention layers):

  k/v        [L, n_pages, page_size, kvh, dh]   device tensors
                                                (int4: [..., dh//2] int8)
  k/v_scale  [L, n_pages, page_size, kvh, 1]    (int8: f32; int4: bf16)
  k/v_redist [L, kvh, dh] f32                   (int4 only; per-head
                                                 redistribution rows, not
                                                 pages)
  page_table [n_slots, pages_per_slot] int32    host numpy, 0 = unallocated
  refcount   [n_pages] int32                    host numpy

Page 0 is a reserved scratch page: writes that must land nowhere go
there and it is never read back for a live row.  Pages are refcounted for
prefix sharing, with copy-on-write before a slot writes into a shared
page.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.serve import kvq


def bucket_pow2(n: int, cap: int) -> int:
    """Round ``n`` up to the next power of two, clamped to [1, cap] — the
    shared bucketing rule for decode page budgets and prefill chunk sizes."""
    n = max(1, min(n, cap))
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def n_attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for b in cfg.blocks if b in ("attn", "local", "global", "moe"))


class PagePool:
    """Fixed-size page pool + per-slot page tables + free-list alloc/free."""

    def __init__(self, cfg: ModelConfig, n_slots: int, s_max: int, *,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 mode: str = "int8", dtype=torch.bfloat16,
                 kv_calib: Optional[dict] = None, device="cuda"):
        if mode not in kvq.KV_MODES:
            raise ValueError(f"unknown page mode {mode!r}")
        self.cfg, self.mode, self.dtype = cfg, mode, dtype
        self.device = torch.device(device)
        self.n_slots, self.page_size = n_slots, page_size
        self.pages_per_slot = max(1, math.ceil(s_max / page_size))
        self.capacity = self.pages_per_slot * page_size
        self.n_pages = (n_pages if n_pages is not None
                        else n_slots * self.pages_per_slot + 1)
        if self.n_pages < 2:
            raise ValueError("pool needs at least one allocatable page")
        L, kvh, dh = n_attn_layers(cfg), cfg.n_kv_heads, cfg.head_dim
        self.quantizer = kvq.make_quantizer(mode, kvh=kvh, dh=dh, dtype=dtype,
                                            calib=kv_calib)
        self.kv: Dict[str, torch.Tensor] = self.quantizer.page_arrays(
            L, self.n_pages, page_size, kvh, dh, self.device)
        # keys whose second axis indexes pages: copy-on-write and the read
        # pricing touch only these; the rest of self.kv is per-pool state
        # (the int4 redistribution rows, [L, kvh, dh])
        self._page_keys = tuple(self.kv)
        self.kv.update(self.quantizer.pool_state(L, kvh, dh, self.device))
        self.page_table = np.zeros((n_slots, self.pages_per_slot), np.int32)
        self.refcount = np.zeros(self.n_pages, np.int32)
        self._free = list(range(self.n_pages - 1, 0, -1))  # pop() -> page 1 first
        self._table_device: Optional[torch.Tensor] = None
        self.alloc_count = 0
        self.free_count = 0
        self.alloc_failures = 0
        self.share_count = 0
        self.cow_count = 0

    # -- alloc / free --------------------------------------------------------

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))

    def _check_span(self, need: int, n_tokens: int) -> None:
        if need > self.pages_per_slot:
            raise ValueError(
                f"{n_tokens} tokens need {need} pages > pages_per_slot="
                f"{self.pages_per_slot} (raise s_max or page_size)")

    def admit(self, slot: int, n_tokens: int, *,
              share_from: Optional[int] = None,
              shared_pages: int = 0) -> bool:
        """Allocate the pages covering [0, n_tokens) for ``slot``; the first
        ``shared_pages`` are mapped from ``share_from``'s table (prefix
        sharing).  False (nothing allocated) when the pool lacks pages."""
        assert not self.page_table[slot].any(), f"slot {slot} already has pages"
        need = self.pages_needed(n_tokens)
        self._check_span(need, n_tokens)
        assert 0 <= shared_pages <= need, (shared_pages, need)
        if shared_pages:
            assert share_from is not None and share_from != slot
            assert np.all(self.page_table[share_from, :shared_pages] > 0)
        if need - shared_pages > len(self._free):
            self.alloc_failures += 1
            return False
        for j in range(shared_pages):
            pid = int(self.page_table[share_from, j])
            self.page_table[slot, j] = pid
            self.refcount[pid] += 1
        self.share_count += shared_pages
        for j in range(shared_pages, need):
            pid = self._free.pop()
            self.page_table[slot, j] = pid
            self.refcount[pid] = 1
        self.alloc_count += need - shared_pages
        self._table_device = None
        return True

    def ensure(self, slot: int, page_idx: int) -> bool:
        """Back logical page ``page_idx`` of ``slot``; False on exhaustion."""
        if self.page_table[slot, page_idx]:
            return True
        if not self._free:
            self.alloc_failures += 1
            return False
        pid = self._free.pop()
        self.page_table[slot, page_idx] = pid
        self.refcount[pid] = 1
        self.alloc_count += 1
        self._table_device = None
        return True

    def ensure_writable(self, slot: int, page_idx: int) -> bool:
        """Back logical page ``page_idx`` and make it private to ``slot``
        (copy-on-write of a shared page).  False on pool exhaustion."""
        if not self.ensure(slot, page_idx):
            return False
        old = int(self.page_table[slot, page_idx])
        if self.refcount[old] <= 1:
            return True
        if not self._free:
            self.alloc_failures += 1
            return False
        new = self._free.pop()
        for name in self._page_keys:        # every layer at once, in place
            self.kv[name][:, new] = self.kv[name][:, old]
        self.refcount[old] -= 1
        self.refcount[new] = 1
        self.page_table[slot, page_idx] = new
        self.alloc_count += 1
        self.cow_count += 1
        self._table_device = None
        return True

    def detach_prefix(self, slot: int, n_tokens: int) -> list:
        """Move ownership of the pages covering [0, n_tokens) out of
        ``slot`` (refcounts kept) and release the rest; the caller hands
        them back via :meth:`readmit` or drops them via
        :meth:`drop_detached` (true chunk-boundary resume)."""
        keep = self.pages_needed(n_tokens) if n_tokens > 0 else 0
        kept = [int(p) for p in self.page_table[slot, :keep] if p]
        self.page_table[slot, :keep] = 0
        self.release(slot)
        return kept

    def readmit(self, slot: int, n_tokens: int, pages: list) -> bool:
        """Re-admit a slot whose first ``len(pages)`` logical pages are the
        detached ``pages``; allocate only the remainder of [0, n_tokens)."""
        assert not self.page_table[slot].any(), f"slot {slot} already has pages"
        need = self.pages_needed(n_tokens)
        self._check_span(need, n_tokens)
        k = len(pages)
        assert k <= need, (k, need, "detached pages exceed the prompt's span")
        if need - k > len(self._free):
            self.alloc_failures += 1
            return False
        for j, pid in enumerate(pages):
            assert self.refcount[pid] > 0, (pid, "readmit of a freed page")
            self.page_table[slot, j] = pid
        for j in range(k, need):
            pid = self._free.pop()
            self.page_table[slot, j] = pid
            self.refcount[pid] = 1
        self.alloc_count += need - k
        self._table_device = None
        return True

    def drop_detached(self, pages: list) -> int:
        """Drop the caller's references on detached pages; returns the
        number of pages freed."""
        freed = []
        for p in pages:
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                freed.append(int(p))
        self._free.extend(reversed(freed))
        self.free_count += len(freed)
        return len(freed)

    def release(self, slot: int) -> int:
        """Drop every page mapping owned by ``slot``; returns pages freed."""
        freed = []
        for p in self.page_table[slot]:
            if not p:
                continue
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                freed.append(int(p))
        self._free.extend(reversed(freed))
        self.free_count += len(freed)
        self.page_table[slot] = 0
        self._table_device = None
        return len(freed)

    # -- device state --------------------------------------------------------

    def table(self) -> torch.Tensor:
        """The page table as a device tensor (cached until it changes)."""
        if self._table_device is None:
            self._table_device = torch.tensor(self.page_table, device=self.device)
        return self._table_device

    def state(self) -> Dict[str, torch.Tensor]:
        return self.kv

    def adopt(self, kv: Dict[str, torch.Tensor]) -> None:
        """Take the step's pool arrays (the steps update in place, so this
        is the same dict; kept so the step contract matches the
        reference's)."""
        assert set(kv) == set(self.kv), (set(kv), set(self.kv))
        self.kv = kv

    # -- block-sparse read budget --------------------------------------------

    def live_page_counts(self) -> np.ndarray:
        return (self.page_table > 0).sum(axis=1).astype(np.int32)

    def live_pages(self) -> np.ndarray:
        """Physical page ids mapped by at least one slot (refcount > 0):
        what the quality observer samples."""
        return np.flatnonzero(self.refcount > 0)

    def bucket_pages(self, n_needed: int) -> int:
        return bucket_pow2(n_needed, self.pages_per_slot)

    def page_read_bytes(self) -> int:
        """Bytes one page costs to read across all layers (K + V + scales;
        int4 counts the packed nibble bytes).  Only page-indexed arrays
        count: the int4 redistribution rows are per-pool constants."""
        return sum(self.kv[n].numel() * self.kv[n].element_size()
                   for n in self._page_keys) // self.n_pages

    # -- accounting ----------------------------------------------------------

    def cache_bytes(self) -> int:
        """Bytes the pool holds on the device: every page of every layer,
        live or free, plus the int4 redistribution rows (the reference's
        ``kvcache.cache_bytes`` counts them too)."""
        return sum(a.numel() * a.element_size() for a in self.kv.values())

    def stats(self, slot_lens: Optional[Dict[int, int]] = None) -> Dict[str, float]:
        usable = self.n_pages - 1
        out = {
            "pages_total": usable,
            "pages_in_use": self.pages_in_use,
            "occupancy": self.pages_in_use / usable if usable else 0.0,
            "alloc_count": self.alloc_count,
            "free_count": self.free_count,
            "alloc_failures": self.alloc_failures,
            "cache_bytes": self.cache_bytes(),
            "cache_bytes_per_shard": self.cache_bytes(),
            "kv_shards": 1,
            "kv_mode": self.mode,
            "bytes_per_token": self.page_read_bytes() / self.page_size,
            "pages_shared": int((self.refcount > 1).sum()),
            "share_count": self.share_count,
            "cow_count": self.cow_count,
        }
        if slot_lens is not None:
            cap = self.pages_in_use * self.page_size
            live = sum(slot_lens.values())
            out["live_tokens"] = live
            out["internal_fragmentation"] = (
                max(0.0, 1.0 - live / cap) if cap else 0.0)
        return out
