"""Iteration-level (continuous batching) scheduler.

Semantics mirror the reference (qserve/core/scheduler.py): FCFS admission of
waiting prompts under token/seq/watermark budgets, decode batching of RUNNING
groups, preemption by recompute or swap when pages run out, and swap-in of
preempted groups — over integer page ids.
"""

from __future__ import annotations

import enum
import time
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from qserve_tpu_torch.config import CacheConfig, SchedulerConfig
from qserve_tpu_torch.core.block_manager import AllocStatus, BlockSpaceManager
from qserve_tpu_torch.core.policy import PolicyFactory
from qserve_tpu_torch.logger import init_logger
from qserve_tpu_torch.sequence import (
    Sequence,
    SequenceGroup,
    SequenceGroupMetadata,
    SequenceStatus,
)

logger = init_logger(__name__)


class PreemptionMode(enum.Enum):
    SWAP = enum.auto()
    RECOMPUTE = enum.auto()


class SchedulerOutputs:
    def __init__(
        self,
        scheduled_seq_groups: List[SequenceGroup],
        prompt_run: bool,
        num_batched_tokens: int,
        blocks_to_swap_in: Dict[int, int],
        blocks_to_swap_out: Dict[int, int],
        blocks_to_copy: Dict[int, List[int]],
        ignored_seq_groups: List[SequenceGroup],
        prompt_chunks: Optional[Dict[int, Tuple[int, int]]] = None,
        decode_groups: Optional[List[SequenceGroup]] = None,
    ) -> None:
        self.scheduled_seq_groups = scheduled_seq_groups
        self.prompt_run = prompt_run
        self.num_batched_tokens = num_batched_tokens
        self.blocks_to_swap_in = blocks_to_swap_in
        self.blocks_to_swap_out = blocks_to_swap_out
        self.blocks_to_copy = blocks_to_copy
        self.ignored_seq_groups = ignored_seq_groups
        # seq_id -> (start, end) prompt span computed this step (chunked
        # prefill / prefix compute-skip); absent = whole prompt
        self.prompt_chunks = prompt_chunks or {}
        # RUNNING groups decoding in the same step as a prefill chunk
        # (mixed chunk+decode: the fused [T+B] step fn)
        self.decode_groups = decode_groups or []

    def is_empty(self) -> bool:
        return (
            not self.scheduled_seq_groups
            and not self.blocks_to_swap_in
            and not self.blocks_to_swap_out
            and not self.blocks_to_copy
        )


class Scheduler:
    def __init__(
        self,
        scheduler_config: SchedulerConfig,
        cache_config: CacheConfig,
    ) -> None:
        self.scheduler_config = scheduler_config
        self.cache_config = cache_config
        if (
            getattr(scheduler_config, "enable_chunked_prefill", True)
            and scheduler_config.max_num_batched_tokens < cache_config.block_size
        ):
            # chunks are page-aligned; a budget below one page would compute
            # a zero-token chunk and livelock the waiting-queue head
            raise ValueError(
                f"max_num_batched_tokens "
                f"({scheduler_config.max_num_batched_tokens}) must be >= the "
                f"KV cache block_size ({cache_config.block_size}) when "
                f"chunked prefill is enabled"
            )
        self.policy = PolicyFactory.get_policy("fcfs")
        self.block_manager = BlockSpaceManager(
            block_size=cache_config.block_size,
            num_device_pages=cache_config.num_device_pages or 0,
            num_cpu_pages=cache_config.num_cpu_pages,
            sliding_window=getattr(cache_config, "sliding_window", None),
        )
        self.waiting: Deque[SequenceGroup] = deque()
        self.running: Deque[SequenceGroup] = deque()
        self.swapped: Deque[SequenceGroup] = deque()
        from qserve_tpu_torch.core.prefix import PrefixPool

        self.prefix_pool = PrefixPool(cache_config.block_size)

    # ---- request lifecycle ----
    def add_seq_group(self, seq_group: SequenceGroup) -> None:
        self.waiting.append(seq_group)

    def abort_seq_group(self, request_ids: Iterable[str]) -> None:
        ids = set(request_ids)
        for queue in (self.waiting, self.running, self.swapped):
            kept = deque()
            for group in queue:
                if group.request_id in ids:
                    for seq in group.get_seqs():
                        if not seq.is_finished():
                            seq.status = SequenceStatus.FINISHED_ABORTED
                            self.free_seq(seq)
                else:
                    kept.append(group)
            queue.clear()
            queue.extend(kept)

    def has_unfinished_seqs(self) -> bool:
        return bool(self.waiting or self.running or self.swapped)

    def get_num_unfinished_seq_groups(self) -> int:
        return len(self.waiting) + len(self.running) + len(self.swapped)

    # ---- the scheduling step ----
    def schedule(self) -> Tuple[List[SequenceGroupMetadata], SchedulerOutputs]:
        outputs = self._schedule()
        metadata: List[SequenceGroupMetadata] = []
        for group in outputs.scheduled_seq_groups:
            seq_data = {}
            block_tables = {}
            chunk = None
            if outputs.prompt_run:
                # a partially-prefilled (chunked) prompt is still WAITING
                seqs = [s for s in group.get_seqs() if not s.is_finished()]
            else:
                seqs = group.get_seqs(SequenceStatus.RUNNING)
            for seq in seqs:
                seq_data[seq.seq_id] = seq.data
                block_tables[seq.seq_id] = list(self.block_manager.get_page_table(seq))
                if seq.seq_id in outputs.prompt_chunks:
                    chunk = outputs.prompt_chunks[seq.seq_id]
            metadata.append(
                SequenceGroupMetadata(
                    request_id=group.request_id,
                    is_prompt=outputs.prompt_run,
                    seq_data=seq_data,
                    sampling_params=group.sampling_params,
                    block_tables=block_tables,
                    multi_modal_data=group.multi_modal_data,
                    chunk=chunk,
                )
            )
        for group in outputs.decode_groups:
            seqs = group.get_seqs(SequenceStatus.RUNNING)
            metadata.append(
                SequenceGroupMetadata(
                    request_id=group.request_id,
                    is_prompt=False,
                    seq_data={s.seq_id: s.data for s in seqs},
                    sampling_params=group.sampling_params,
                    block_tables={
                        s.seq_id: list(self.block_manager.get_page_table(s))
                        for s in seqs
                    },
                    multi_modal_data=group.multi_modal_data,
                )
            )
        return metadata, outputs

    def _schedule(self) -> SchedulerOutputs:
        now = time.time()
        blocks_to_swap_in: Dict[int, int] = {}
        blocks_to_swap_out: Dict[int, int] = {}
        blocks_to_copy: Dict[int, List[int]] = {}
        ignored: List[SequenceGroup] = []

        # Phase 1: admit new prompts (only when nothing is swapped out,
        # mirroring the reference's ordering guarantee). Prompts longer than
        # the token budget prefill in page-aligned CHUNKS (the reference
        # rejects them, ref scheduler.py:192-201); a chunked prompt runs
        # alone in its step and stays at the head of the waiting queue until
        # its last chunk. Computed shared prefixes are skipped by starting
        # the span at prefix.length (compute-level prefix reuse).
        if not self.swapped:
            scheduled: List[SequenceGroup] = []
            prompt_chunks: Dict[int, Tuple[int, int]] = {}
            num_batched_tokens = 0
            num_running_seqs = sum(
                g.get_max_num_running_seqs() for g in self.running
            )
            # a waiting prompt that already HOLDS pages (mid-chunk, or
            # allocated but budget-deferred) must keep making progress even
            # when recompute-preempted groups were appendleft'ed ahead of it,
            # or the queue head can deadlock waiting for the pages it is
            # sitting on (at most one group is in that state at a time; page
            # ownership — not prefill progress — is the deadlock condition)
            for i, g in enumerate(self.waiting):
                ws = g.get_seqs(SequenceStatus.WAITING)
                if ws and self.block_manager.has_seq(ws[0]):
                    if i > 0:
                        del self.waiting[i]
                        self.waiting.appendleft(g)
                    break
            while self.waiting:
                group = self.waiting[0]
                waiting_seqs = group.get_seqs(SequenceStatus.WAITING)
                assert len(waiting_seqs) == 1, "prompt groups have one seq"
                seq = waiting_seqs[0]
                prompt_len = seq.get_len()
                chunking = getattr(
                    self.scheduler_config, "enable_chunked_prefill", True
                )
                limit = (
                    self.scheduler_config.max_model_len - 1
                    if chunking
                    else min(
                        self.scheduler_config.max_model_len,
                        self.scheduler_config.max_num_batched_tokens,
                    )
                )
                if prompt_len > limit:
                    logger.warning(
                        "Prompt (%d tokens) exceeds limit; ignoring request %s",
                        prompt_len, group.request_id,
                    )
                    seq.status = SequenceStatus.FINISHED_IGNORED
                    ignored.append(group)
                    self.waiting.popleft()
                    continue

                if not self.block_manager.has_seq(seq):
                    alloc = self.block_manager.can_allocate(group)
                    if alloc == AllocStatus.NEVER:
                        logger.warning(
                            "Prompt of request %s can never fit in KV cache; "
                            "ignoring", group.request_id,
                        )
                        seq.status = SequenceStatus.FINISHED_IGNORED
                        ignored.append(group)
                        self.waiting.popleft()
                        continue
                    if alloc == AllocStatus.LATER:
                        break
                    new_seqs = group.get_max_num_running_seqs()
                    if (
                        num_running_seqs + new_seqs
                        > self.scheduler_config.max_num_seqs
                    ):
                        break
                    self.block_manager.allocate(group)
                    if chunking and group.sampling_params.best_of == 1:
                        self._apply_prefix_skip(group, seq)
                    num_running_seqs += new_seqs

                start = seq.data.computed_tokens
                remaining = prompt_len - start
                budget = (
                    self.scheduler_config.max_num_batched_tokens
                    - num_batched_tokens
                )
                if budget <= 0:
                    break
                if start > 0 and scheduled:
                    break  # prefix-continuation steps run alone (B=1 path)
                if remaining > budget:
                    # chunked: page-aligned partial span, alone in its step
                    if scheduled:
                        break
                    bs = self.cache_config.block_size
                    chunk = (budget // bs) * bs
                    if chunk <= 0:
                        break
                    end = start + chunk
                else:
                    end = prompt_len

                seq.data.computed_tokens = end
                prompt_chunks[seq.seq_id] = (start, end)
                num_batched_tokens += end - start
                scheduled.append(group)
                if end == prompt_len:
                    self.waiting.popleft()
                    seq.status = SequenceStatus.RUNNING
                    self.running.append(group)
                    if start > 0:
                        break  # ran with a cached prefix: keep the step B=1
                else:
                    break  # unfinished chunk stays at the queue head

            if scheduled or ignored:
                # a chunk / prefix-continuation step runs one prompt at B=1;
                # batch the running decode groups into the same step (fused
                # [T+B] stream) so decodes never stall during the admission
                decode_groups: List[SequenceGroup] = []
                if (
                    scheduled
                    and self.running
                    and getattr(
                        self.scheduler_config, "mixed_chunk_decode", True
                    )
                    and len(scheduled) == 1
                    # best_of>1 chunks use the logits-returning step fn,
                    # which has no fused-decode variant
                    and scheduled[0].sampling_params.best_of == 1
                ):
                    chunk_group = scheduled[0]
                    seq = next(
                        s for s in chunk_group.get_seqs()
                        if not s.is_finished()
                    )
                    start, end = prompt_chunks[seq.seq_id]
                    if start > 0 or end < seq.get_len():
                        # a FINAL chunk just moved its group into running;
                        # it must not also decode this step (its next slot
                        # is appended on the next decode step)
                        in_running = chunk_group in self.running
                        if in_running:
                            self.running.remove(chunk_group)
                        self._schedule_running(
                            now, blocks_to_swap_out, blocks_to_copy
                        )
                        decode_groups = list(self.running)
                        if in_running:
                            self.running.append(chunk_group)
                        num_batched_tokens += sum(
                            g.num_seqs(SequenceStatus.RUNNING)
                            for g in decode_groups
                        )
                return SchedulerOutputs(
                    scheduled_seq_groups=scheduled,
                    prompt_run=True,
                    num_batched_tokens=num_batched_tokens,
                    blocks_to_swap_in=blocks_to_swap_in,
                    blocks_to_swap_out=blocks_to_swap_out,
                    blocks_to_copy=blocks_to_copy,
                    ignored_seq_groups=ignored,
                    prompt_chunks=prompt_chunks,
                    decode_groups=decode_groups,
                )

        # Phase 2: decode step for running groups; preempt if out of pages.
        preempted = self._schedule_running(
            now, blocks_to_swap_out, blocks_to_copy
        )

        # Phase 3: try to swap preempted groups back in.
        self.swapped = deque(self.policy.sort_by_priority(now, self.swapped))
        if not preempted:
            num_running_seqs = sum(
                g.get_max_num_running_seqs() for g in self.running
            )
            while self.swapped:
                group = self.swapped[0]
                if not self.block_manager.can_swap_in(group):
                    break
                new_seqs = group.get_max_num_running_seqs()
                if num_running_seqs + new_seqs > self.scheduler_config.max_num_seqs:
                    break
                self.swapped.popleft()
                mapping = self.block_manager.swap_in(group)
                blocks_to_swap_in.update(mapping)
                for seq in group.get_seqs(SequenceStatus.SWAPPED):
                    seq.status = SequenceStatus.RUNNING
                self._append_slots(group, blocks_to_copy)
                self.running.append(group)
                num_running_seqs += new_seqs

        num_batched_tokens = sum(
            g.num_seqs(SequenceStatus.RUNNING) for g in self.running
        )
        return SchedulerOutputs(
            scheduled_seq_groups=list(self.running),
            prompt_run=False,
            num_batched_tokens=num_batched_tokens,
            blocks_to_swap_in=blocks_to_swap_in,
            blocks_to_swap_out=blocks_to_swap_out,
            blocks_to_copy=blocks_to_copy,
            ignored_seq_groups=[],
        )

    # ---- helpers ----
    def _schedule_running(
        self,
        now: float,
        blocks_to_swap_out: Dict[int, int],
        blocks_to_copy: Dict[int, List[int]],
    ) -> List[SequenceGroup]:
        """Decode scheduling for RUNNING groups: append a slot per sequence,
        preempting lowest-priority groups when pages run out. Leaves the
        groups decoding this step in self.running; returns the preempted."""
        self.running = deque(self.policy.sort_by_priority(now, self.running))
        running: Deque[SequenceGroup] = deque()
        preempted: List[SequenceGroup] = []
        while self.running:
            group = self.running.popleft()
            while not self.block_manager.can_append_slot(group):
                if self.running:
                    victim = self.running.pop()  # lowest priority
                    self._preempt(victim, blocks_to_swap_out)
                    preempted.append(victim)
                else:
                    self._preempt(group, blocks_to_swap_out)
                    preempted.append(group)
                    break
            else:
                self._append_slots(group, blocks_to_copy)
                running.append(group)
        self.running = running
        return preempted

    def _allocate(self, group: SequenceGroup) -> None:
        self.block_manager.allocate(group)
        for seq in group.get_seqs(SequenceStatus.WAITING):
            seq.status = SequenceStatus.RUNNING

    def _apply_prefix_skip(self, group: SequenceGroup, seq: Sequence) -> None:
        """Start prefill past a COMPUTED shared prefix (its pages are reused
        by allocation and already hold the KV). The skip is page-aligned so
        chunk boundaries never start mid-page (the staged full-page append
        requires it), and at least one token is always computed."""
        prefix = getattr(group, "prefix", None)
        if prefix is None or not (prefix.allocated and prefix.computed):
            return
        bs = self.cache_config.block_size
        skip = min(prefix.length, ((seq.get_len() - 1) // bs) * bs)
        seq.data.computed_tokens = max(skip, 0)

    def _append_slots(
        self, group: SequenceGroup, blocks_to_copy: Dict[int, List[int]]
    ) -> None:
        for seq in group.get_seqs(SequenceStatus.RUNNING):
            cow = self.block_manager.append_slot(seq)
            if cow is not None:
                src, dst = cow
                blocks_to_copy.setdefault(src, []).append(dst)

    def _preempt(
        self,
        group: SequenceGroup,
        blocks_to_swap_out: Dict[int, int],
        mode: Optional[PreemptionMode] = None,
    ) -> None:
        if mode is None:
            # single-stream groups are cheapest to recompute (reference default)
            mode = (
                PreemptionMode.RECOMPUTE
                if group.get_max_num_running_seqs() == 1
                else PreemptionMode.SWAP
            )
        if mode == PreemptionMode.SWAP and not self.block_manager.can_swap_out(group):
            if group.get_max_num_running_seqs() > 1:
                # forked candidates can't re-enter the prompt queue (one
                # waiting seq per group); without swap space this is fatal,
                # matching the reference's swap-space RuntimeError
                raise RuntimeError(
                    "cannot preempt a multi-candidate group without CPU swap "
                    "space; increase num_cpu_pages or reduce load"
                )
            mode = PreemptionMode.RECOMPUTE
        if mode == PreemptionMode.RECOMPUTE:
            for seq in group.get_seqs(SequenceStatus.RUNNING):
                seq.status = SequenceStatus.WAITING
                self.block_manager.free(seq)
                # keep generated tokens: they re-enter as part of the prompt
                seq.data.computed_tokens = 0  # pages freed; KV is gone
            self.waiting.appendleft(group)
        else:
            mapping = self.block_manager.swap_out(group)
            blocks_to_swap_out.update(mapping)
            for seq in group.get_seqs(SequenceStatus.RUNNING):
                seq.status = SequenceStatus.SWAPPED
            self.swapped.append(group)

    def free_seq(self, seq: Sequence) -> None:
        self.block_manager.free(seq)

    def free_finished_seq_groups(self) -> None:
        self.running = deque(g for g in self.running if not g.is_finished())

    def fork_seq(self, parent: Sequence, child: Sequence) -> None:
        self.block_manager.fork(parent, child)
