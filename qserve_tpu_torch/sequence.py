"""Request / sequence state machine (reference: qserve/sequence.py).

A Sequence owns its token ids and paging needs; a SequenceGroup is one user
request (n candidate sequences); SequenceGroupMetadata is the per-step
snapshot the scheduler hands to the model runner.
"""

from __future__ import annotations

import enum
import time
from typing import Dict, List, Optional, Tuple

from qserve_tpu_torch.sampling_params import SamplingParams


class SequenceStatus(enum.Enum):
    WAITING = enum.auto()
    RUNNING = enum.auto()
    SWAPPED = enum.auto()
    FINISHED_STOPPED = enum.auto()
    FINISHED_LENGTH_CAPPED = enum.auto()
    FINISHED_ABORTED = enum.auto()
    FINISHED_IGNORED = enum.auto()

    @staticmethod
    def is_finished(status: "SequenceStatus") -> bool:
        return status in (
            SequenceStatus.FINISHED_STOPPED,
            SequenceStatus.FINISHED_LENGTH_CAPPED,
            SequenceStatus.FINISHED_ABORTED,
            SequenceStatus.FINISHED_IGNORED,
        )

    @staticmethod
    def get_finished_reason(status: "SequenceStatus") -> Optional[str]:
        return {
            SequenceStatus.FINISHED_STOPPED: "stop",
            SequenceStatus.FINISHED_LENGTH_CAPPED: "length",
            SequenceStatus.FINISHED_ABORTED: "abort",
            SequenceStatus.FINISHED_IGNORED: "length",
        }.get(status)


class SequenceData:
    """Token ids + cumulative logprob of one sequence."""

    def __init__(self, prompt_token_ids: List[int]) -> None:
        self.prompt_token_ids = list(prompt_token_ids)
        self.output_token_ids: List[int] = []
        self.cumulative_logprob = 0.0
        # prompt tokens whose KV is already computed (chunked prefill
        # progress; also pre-advanced over computed shared prefixes)
        self.computed_tokens = 0

    def append_token_id(self, token_id: int, logprob: float = 0.0) -> None:
        self.output_token_ids.append(token_id)
        self.cumulative_logprob += logprob

    def get_len(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    def get_prompt_len(self) -> int:
        return len(self.prompt_token_ids)

    def get_output_len(self) -> int:
        return len(self.output_token_ids)

    def get_token_ids(self) -> List[int]:
        return self.prompt_token_ids + self.output_token_ids

    def get_last_token_id(self) -> int:
        if self.output_token_ids:
            return self.output_token_ids[-1]
        return self.prompt_token_ids[-1]


class Sequence:
    """One decoding stream: tokens + page-count bookkeeping.

    extra_page_slots reserves room for tokens materialized later (the VLM
    path inserts image-embedding tokens at prefill: 196 per image, reference
    sequence.py:167-172).
    """

    def __init__(
        self,
        seq_id: int,
        prompt: Optional[str],
        prompt_token_ids: List[int],
        block_size: int,
        extra_page_slots: int = 0,
    ) -> None:
        self.seq_id = seq_id
        self.prompt = prompt
        self.block_size = block_size
        self.data = SequenceData(prompt_token_ids)
        self.extra_page_slots = extra_page_slots
        self.status = SequenceStatus.WAITING
        self.output_text = ""
        # incremental detokenization state
        self.prefix_offset = 0
        self.read_offset = 0
        self.tokens: Optional[List[str]] = None

    def num_total_slots(self) -> int:
        return self.data.get_len() + self.extra_page_slots

    def num_required_pages(self) -> int:
        return -(-self.num_total_slots() // self.block_size)

    def append_token_id(self, token_id: int, logprob: float = 0.0) -> None:
        self.data.append_token_id(token_id, logprob)

    def get_len(self) -> int:
        return self.data.get_len()

    def get_prompt_len(self) -> int:
        return self.data.get_prompt_len()

    def get_output_len(self) -> int:
        return self.data.get_output_len()

    def get_token_ids(self) -> List[int]:
        return self.data.get_token_ids()

    def get_last_token_id(self) -> int:
        return self.data.get_last_token_id()

    def is_finished(self) -> bool:
        return SequenceStatus.is_finished(self.status)

    def fork(self, new_seq_id: int) -> "Sequence":
        import copy

        child = Sequence(
            new_seq_id, self.prompt, [], self.block_size, self.extra_page_slots
        )
        child.data = copy.deepcopy(self.data)
        child.status = self.status
        child.output_text = self.output_text
        return child

    def __repr__(self) -> str:
        return f"Sequence(id={self.seq_id}, status={self.status.name}, len={self.get_len()})"


class SequenceGroup:
    """One request: n sibling sequences sharing a prompt + sampling params."""

    def __init__(
        self,
        request_id: str,
        seqs: List[Sequence],
        sampling_params: SamplingParams,
        arrival_time: Optional[float] = None,
        multi_modal_data: Optional[dict] = None,
        prefix=None,  # core.prefix.Prefix — shared-prompt page reuse
    ) -> None:
        self.request_id = request_id
        self.seqs_dict: Dict[int, Sequence] = {s.seq_id: s for s in seqs}
        self.sampling_params = sampling_params
        self.arrival_time = arrival_time if arrival_time is not None else time.time()
        self.multi_modal_data = multi_modal_data or {}
        self.prefix = prefix
        # when the request was queued, on time.perf_counter_ns(); None once
        # the scheduler first scheduled its prompt (its queue wait counted)
        self.queued_ns: Optional[int] = time.perf_counter_ns()

    @property
    def prompt(self) -> Optional[str]:
        return next(iter(self.seqs_dict.values())).prompt

    @property
    def prompt_token_ids(self) -> List[int]:
        return next(iter(self.seqs_dict.values())).data.prompt_token_ids

    def get_seqs(self, status: Optional[SequenceStatus] = None) -> List[Sequence]:
        seqs = list(self.seqs_dict.values())
        if status is None:
            return seqs
        return [s for s in seqs if s.status == status]

    def get_max_num_running_seqs(self) -> int:
        if self.sampling_params.best_of > self.num_seqs():
            return self.sampling_params.best_of
        return self.num_unfinished_seqs()

    def num_seqs(self, status: Optional[SequenceStatus] = None) -> int:
        return len(self.get_seqs(status))

    def num_unfinished_seqs(self) -> int:
        return len([s for s in self.seqs_dict.values() if not s.is_finished()])

    def find(self, seq_id: int) -> Sequence:
        return self.seqs_dict[seq_id]

    def add(self, seq: Sequence) -> None:
        assert seq.seq_id not in self.seqs_dict
        self.seqs_dict[seq.seq_id] = seq

    def remove(self, seq_id: int) -> None:
        del self.seqs_dict[seq_id]

    def is_finished(self) -> bool:
        return all(s.is_finished() for s in self.seqs_dict.values())

    def __repr__(self) -> str:
        return (
            f"SequenceGroup(request_id={self.request_id}, "
            f"num_seqs={self.num_seqs()})"
        )


class SequenceGroupMetadata:
    """Per-step scheduling snapshot for the model runner.

    block_tables: seq_id -> list of physical page ids.
    """

    def __init__(
        self,
        request_id: str,
        is_prompt: bool,
        seq_data: Dict[int, SequenceData],
        sampling_params: SamplingParams,
        block_tables: Dict[int, List[int]],
        multi_modal_data: Optional[dict] = None,
        chunk: Optional[Tuple[int, int]] = None,
    ) -> None:
        self.request_id = request_id
        self.is_prompt = is_prompt
        self.seq_data = seq_data
        self.sampling_params = sampling_params
        self.block_tables = block_tables
        self.multi_modal_data = multi_modal_data or {}
        # chunked prefill: (start, end) token span of the prompt to compute
        # this step; KV for [0, start) is already in the cache. None = the
        # whole prompt (the common, non-chunked case).
        self.chunk = chunk


class SequenceOutput:
    """One sampled token for one sequence."""

    def __init__(self, parent_seq_id: int, output_token: int, logprob: float = 0.0):
        self.parent_seq_id = parent_seq_id
        self.output_token = output_token
        self.logprob = logprob


class SequenceGroupOutput:
    def __init__(self, request_id: str, samples: List[SequenceOutput]):
        self.request_id = request_id
        self.samples = samples


class RequestOutput:
    """Final (or streaming) user-visible output of a request."""

    def __init__(
        self,
        request_id: str,
        prompt: Optional[str],
        prompt_token_ids: List[int],
        outputs: List[dict],
        finished: bool,
    ) -> None:
        self.request_id = request_id
        self.prompt = prompt
        self.prompt_token_ids = prompt_token_ids
        self.outputs = outputs
        self.finished = finished

    @classmethod
    def from_seq_group(cls, seq_group: SequenceGroup) -> "RequestOutput":
        seqs = seq_group.get_seqs()
        n = seq_group.sampling_params.n
        if len(seqs) > n:
            # best_of > n: return the n best candidates by cumulative logprob
            # (reference sampling_params semantics; ties keep creation order)
            seqs = sorted(
                seqs, key=lambda s: s.data.cumulative_logprob, reverse=True
            )[:n]
        outputs = [
            dict(
                index=i,
                text=seq.output_text,
                token_ids=list(seq.data.output_token_ids),
                finish_reason=SequenceStatus.get_finished_reason(seq.status),
            )
            for i, seq in enumerate(seqs)
        ]
        return cls(
            request_id=seq_group.request_id,
            prompt=seq_group.prompt,
            prompt_token_ids=seq_group.prompt_token_ids,
            outputs=outputs,
            finished=seq_group.is_finished(),
        )
