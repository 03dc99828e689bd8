"""Physical KV page management: ref-counted allocator + logical->physical maps.

Semantics follow the reference BlockSpaceManager (qserve/core/block_manager.py):
watermark admission, copy-on-write on append, fork sharing, swap bookkeeping —
re-expressed over integer page ids into the device cache pool.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Set, Tuple

from qserve_tpu_torch.sequence import Sequence, SequenceGroup, SequenceStatus

BlockTable = List[int]


class AllocStatus(enum.Enum):
    OK = enum.auto()
    LATER = enum.auto()  # not now, retry when pages free up
    NEVER = enum.auto()  # prompt can never fit


class PageAllocator:
    """Free-list allocator with reference counts over a fixed pool."""

    def __init__(self, num_pages: int) -> None:
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}

    def allocate(self) -> int:
        if not self._free:
            raise RuntimeError("out of KV cache pages")
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def free(self, page: int) -> None:
        ref = self._ref.get(page)
        if ref is None:
            raise ValueError(f"double free of page {page}")
        if ref == 1:
            del self._ref[page]
            self._free.append(page)
        else:
            self._ref[page] = ref - 1

    def incref(self, page: int) -> None:
        self._ref[page] += 1

    def ref_count(self, page: int) -> int:
        return self._ref.get(page, 0)

    def get_num_free(self) -> int:
        return len(self._free)


class BlockSpaceManager:
    """Maps sequences to physical KV pages on device (and a CPU swap pool)."""

    def __init__(
        self,
        block_size: int,
        num_device_pages: int,
        num_cpu_pages: int = 0,
        watermark: float = 0.01,
        sliding_window: Optional[int] = None,
    ) -> None:
        self.block_size = block_size
        self.num_device_pages = num_device_pages
        self.num_cpu_pages = num_cpu_pages
        self.watermark_pages = int(watermark * num_device_pages)
        self.sliding_window_pages = (
            None if sliding_window is None else -(-sliding_window // block_size)
        )
        self.device = PageAllocator(num_device_pages)
        self.cpu = PageAllocator(num_cpu_pages) if num_cpu_pages else None
        self.page_tables: Dict[int, BlockTable] = {}  # seq_id -> pages
        self.swapped_tables: Dict[int, BlockTable] = {}  # seq_id -> cpu pages

    # ---- prompt admission ----
    def can_allocate(self, seq_group: SequenceGroup) -> AllocStatus:
        seq = seq_group.get_seqs(SequenceStatus.WAITING)[0]
        need = seq.num_required_pages()
        prefix = getattr(seq_group, "prefix", None)
        if prefix is not None and prefix.allocated:
            need -= prefix.get_num_pages()  # shared pages already exist
        if self.sliding_window_pages is not None:
            need = min(need, self.sliding_window_pages)
        free = self.device.get_num_free()
        if need > self.num_device_pages - self.watermark_pages:
            return AllocStatus.NEVER
        if free - need >= self.watermark_pages:
            return AllocStatus.OK
        return AllocStatus.LATER

    def allocate(self, seq_group: SequenceGroup) -> None:
        waiting = seq_group.get_seqs(SequenceStatus.WAITING)
        seq = waiting[0]
        need = seq.num_required_pages()
        prefix = getattr(seq_group, "prefix", None)
        pages: BlockTable = []
        if prefix is not None and prefix.allocated:
            # reuse the shared prefix pages (ref-counted; reference
            # prefix.py + block_manager.py:133-183 semantics)
            pages.extend(prefix.get_page_numbers())
            for p in pages:
                self.device.incref(p)
            need -= len(pages)
        pages.extend(self.device.allocate() for _ in range(need))
        if prefix is not None and not prefix.allocated:
            head = pages[: prefix.get_num_pages()]
            prefix.set_page_table(head)
            for p in head:  # the pool itself holds one reference
                self.device.incref(p)
        # siblings (best_of > 1) share the prompt pages copy-on-write
        for s in waiting:
            if s.seq_id != seq.seq_id:
                for p in pages:
                    self.device.incref(p)
            self.page_tables[s.seq_id] = list(pages)

    # ---- decode growth ----
    def can_append_slot(self, seq_group: SequenceGroup) -> bool:
        running = seq_group.num_seqs(SequenceStatus.RUNNING)
        return running <= self.device.get_num_free()

    def append_slot(self, seq: Sequence) -> Optional[Tuple[int, int]]:
        """Ensure a slot exists for the next token.

        Returns (src_page, dst_page) if a copy-on-write happened, else None.
        """
        table = self.page_tables[seq.seq_id]
        need = seq.num_required_pages()
        if need > len(table):
            if self.sliding_window_pages and len(table) >= self.sliding_window_pages:
                # reuse the oldest page cyclically (sliding window)
                table.append(table[len(table) % self.sliding_window_pages])
                return None
            table.append(self.device.allocate())
            return None
        last = table[-1]
        if self.device.ref_count(last) == 1:
            return None
        # shared page: copy-on-write
        new_page = self.device.allocate()
        table[-1] = new_page
        self.device.free(last)
        return last, new_page

    def fork(self, parent: Sequence, child: Sequence) -> None:
        table = self.page_tables[parent.seq_id]
        self.page_tables[child.seq_id] = list(table)
        for p in set(table):
            self.device.incref(p)

    # ---- swap bookkeeping (page data movement is the cache engine's job) ----
    def can_swap_in(self, seq_group: SequenceGroup) -> bool:
        if self.cpu is None:
            return False
        pages = set()
        for seq in seq_group.get_seqs(SequenceStatus.SWAPPED):
            pages.update(self.swapped_tables[seq.seq_id])
        need = len(pages) + seq_group.num_seqs(SequenceStatus.SWAPPED)
        return self.device.get_num_free() - need >= self.watermark_pages

    def swap_in(self, seq_group: SequenceGroup) -> Dict[int, int]:
        assert self.cpu is not None
        mapping: Dict[int, int] = {}
        for seq in seq_group.get_seqs(SequenceStatus.SWAPPED):
            cpu_table = self.swapped_tables.pop(seq.seq_id)
            new_table = []
            for cp in cpu_table:
                if cp not in mapping:
                    mapping[cp] = self.device.allocate()
                else:
                    self.device.incref(mapping[cp])
                new_table.append(mapping[cp])
                self.cpu.free(cp)
            self.page_tables[seq.seq_id] = new_table
        return mapping

    def can_swap_out(self, seq_group: SequenceGroup) -> bool:
        if self.cpu is None:
            return False
        pages = set()
        for seq in seq_group.get_seqs(SequenceStatus.RUNNING):
            pages.update(self.page_tables[seq.seq_id])
        return len(pages) <= self.cpu.get_num_free()

    def swap_out(self, seq_group: SequenceGroup) -> Dict[int, int]:
        assert self.cpu is not None
        mapping: Dict[int, int] = {}
        for seq in seq_group.get_seqs(SequenceStatus.RUNNING):
            table = self.page_tables.pop(seq.seq_id)
            cpu_table = []
            for p in table:
                if p not in mapping:
                    mapping[p] = self.cpu.allocate()
                else:
                    self.cpu.incref(mapping[p])
                cpu_table.append(mapping[p])
                self.device.free(p)
            self.swapped_tables[seq.seq_id] = cpu_table
        return mapping

    # ---- teardown ----
    def free(self, seq: Sequence) -> None:
        table = self.page_tables.pop(seq.seq_id, None)
        if table is not None:
            seen: Set[int] = set()
            for p in table:
                if p in seen and self.sliding_window_pages:
                    continue  # cyclic reuse aliases pages
                seen.add(p)
                self.device.free(p)
        cpu_table = self.swapped_tables.pop(seq.seq_id, None)
        if cpu_table is not None and self.cpu is not None:
            for p in cpu_table:
                self.cpu.free(p)

    def reset(self) -> None:
        for seq_id in list(self.page_tables):
            table = self.page_tables.pop(seq_id)
            for p in set(table):
                self.device.free(p)

    def has_seq(self, seq: Sequence) -> bool:
        return seq.seq_id in self.page_tables

    def get_page_table(self, seq: Sequence) -> BlockTable:
        return self.page_tables[seq.seq_id]

    def get_num_free_device_pages(self) -> int:
        return self.device.get_num_free()
