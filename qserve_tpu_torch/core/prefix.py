"""Shared-prompt-prefix pool.

Reference counterpart: qserve/prefix.py (Prefix :8-50, PrefixPool :53-91) —
an experimental pool mapping a hash of the first N prompt tokens (truncated
to a page multiple) to a shared page table with its own ref counts. Matching
the reference's wiring depth: prefixes share *pages* (allocation-level reuse;
the scheduler skips re-allocating them), and `computed` flips after the first
prefill that covers the prefix. From then on the scheduler starts a
sharing prompt at the prefix's end and the model runner prefills only the
suffix, as a chunk step over the cached prefix pages.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


class Prefix:
    """A shared prompt prefix and its page table (reference prefix.py:8-50)."""

    def __init__(self, token_ids: Sequence[int], block_size: int) -> None:
        self.token_ids = tuple(token_ids)
        self.block_size = block_size
        self.length = len(token_ids)
        assert self.length % block_size == 0
        self.page_table: Optional[List[int]] = None
        self.computed = False

    @property
    def allocated(self) -> bool:
        return self.page_table is not None

    def get_num_pages(self) -> int:
        return self.length // self.block_size

    def get_page_numbers(self) -> List[int]:
        assert self.page_table is not None
        return list(self.page_table)

    def match(self, tokens: Sequence[int]) -> bool:
        return tuple(tokens[: self.length]) == self.token_ids

    def set_page_table(self, page_table: Sequence[int]) -> None:
        self.page_table = list(page_table)

    def __hash__(self) -> int:
        return hash(self.token_ids)


class PrefixPool:
    """Dedup pool of Prefix objects keyed by their token hash
    (reference prefix.py:53-91)."""

    def __init__(self, block_size: int) -> None:
        self.prefixes: dict = {}
        self.block_size = block_size

    def _truncate(self, token_ids: Sequence[int]) -> Tuple[int, ...]:
        n = (len(token_ids) // self.block_size) * self.block_size
        return tuple(token_ids[:n])

    def add_or_get_prefix(self, token_ids: Sequence[int]) -> Optional[Prefix]:
        ids = self._truncate(token_ids)
        if not ids:
            return None
        # Keyed by the token tuple itself (not its hash): a hash collision
        # would silently attach another prompt's shared pages to this request
        # and corrupt live sequences' KV reads.
        if ids not in self.prefixes:
            self.prefixes[ids] = Prefix(ids, self.block_size)
        return self.prefixes[ids]

    def __len__(self) -> int:
        return len(self.prefixes)
