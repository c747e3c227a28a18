"""Host-side page allocator for the paged (blocked) KV cache.

The dense slot cache reserves ``max_target_len`` rows per slot up
front, so concurrency is capped by the WORST-case sequence length long
before HBM is: a 128-token chat completion on a 2048-row slot pins 16x
the KV it will ever touch ("Exploring the limits of Concurrency"
framing, PAPERS.md). The paged cache (vLLM-style) slices the KV arena
into fixed-size pages; each slot owns a block table mapping its
logical KV blocks to physical pages, and admission is gated by FREE
PAGES for the request's actual budget (prompt + max_new_tokens), not
by slot count.

Reservation policy: a slot's pages for its full token budget are
reserved at admission. That keeps the decode loop allocation-free (the
fused on-device loop can never outrun its pages mid-batch, so there is
no preemption/swap path to build or test) while still admitting by
true KV need — the concurrency win over dense reservation is
budget/max_target_len per request.

Everything here is plain-Python bookkeeping on the admission/release
path — sets and lists, no device work, no blocking primitives (the
allocator sits under the orchestrator's hot-path purity contract).

The sentinel page index ``num_pages`` marks unallocated block-table
entries: the device arena carries one spare page at that index, which
takes every write routed to the sentinel and is never read (attention
sees pages [0, num_pages) only and clamps the sentinel before indexing)
— a released slot still ticking inside a fused decode batch can
therefore never write into a page that was handed to a new request.

A copy of ``skypilot_tpu/infer/paged_kv.py`` (stdlib + numpy), kept here
because the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class PageAllocator:
    """Free-list allocator mapping decode slots to KV-cache pages.

    One instance covers every layer: the cache layout is
    [L, num_pages + 1, page_size, ...], so a "page" here is the same
    physical page in all L layers and one table serves the whole stack.
    """

    def __init__(self, num_pages: int, page_size: int,
                 blocks_per_slot: int) -> None:
        if num_pages <= 0 or page_size <= 0 or blocks_per_slot <= 0:
            raise ValueError(
                f'PageAllocator needs positive sizes, got '
                f'num_pages={num_pages} page_size={page_size} '
                f'blocks_per_slot={blocks_per_slot}')
        self.num_pages = num_pages
        self.page_size = page_size
        self.blocks_per_slot = blocks_per_slot
        # LIFO free list: recently-released pages are handed out first
        # (their rows are hottest in whatever cache level still holds
        # them, and reuse keeps the touched footprint small).
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {}

    # ---- queries ----

    @property
    def sentinel(self) -> int:
        """Block-table value meaning "no page": device writes to it land
        in the arena's spare page, kernel reads clamp it."""
        return self.num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold `tokens` KV rows."""
        return -(-max(int(tokens), 0) // self.page_size)

    def can_admit(self, tokens: int) -> bool:
        """Whether a request needing `tokens` total KV rows fits the
        free list AND a slot's block table right now."""
        need = self.pages_for(tokens)
        return need <= len(self._free) and need <= self.blocks_per_slot

    def slot_pages(self, slot: int) -> Optional[List[int]]:
        pages = self._owned.get(slot)
        return None if pages is None else list(pages)

    # ---- allocate / release ----

    def allocate(self, slot: int, tokens: int) -> bool:
        """Reserve pages covering `tokens` KV rows for `slot`.

        False (and no state change) when the free list or the slot's
        block table cannot cover it — the caller defers admission.
        Double allocation of a live slot is a scheduler bug, not a
        recoverable condition.
        """
        if slot in self._owned:
            raise ValueError(f'slot {slot} already holds '
                             f'{len(self._owned[slot])} pages')
        need = self.pages_for(tokens)
        if need > len(self._free) or need > self.blocks_per_slot:
            return False
        self._owned[slot] = [self._free.pop() for _ in range(need)]
        return True

    def release(self, slot: int) -> None:
        """Return a slot's pages to the free list (idempotent: release
        of a slot that holds nothing is a no-op, so every
        finish/cancel/failure path can call it unconditionally)."""
        pages = self._owned.pop(slot, None)
        if pages:
            self._free.extend(reversed(pages))

    def release_all(self) -> None:
        for slot in list(self._owned):
            self.release(slot)

    # ---- block-table rows ----

    def table_row(self, slot: int) -> np.ndarray:
        """The slot's full block-table row [blocks_per_slot] int32:
        physical page per logical block, sentinel beyond the
        reservation (and everywhere for an unallocated slot)."""
        row = np.full((self.blocks_per_slot,), self.sentinel, np.int32)
        pages = self._owned.get(slot)
        if pages:
            row[:len(pages)] = pages
        return row
