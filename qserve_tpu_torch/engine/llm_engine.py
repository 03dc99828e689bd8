"""LLMEngine: the top-level serving orchestrator
(qserve_tpu/engine/llm_engine.py) — enqueue requests, drive schedule ->
execute -> postprocess each step, stop-condition checks, detokenization.
One engine process drives one device.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from qserve_tpu_torch.config import CacheConfig, SchedulerConfig
from qserve_tpu_torch.core.scheduler import Scheduler
from qserve_tpu_torch.logger import init_logger
from qserve_tpu_torch.sampling_params import SamplingParams
from qserve_tpu_torch.sequence import (
    RequestOutput,
    Sequence,
    SequenceGroup,
    SequenceStatus,
)
from qserve_tpu_torch.utils import tracing
from qserve_tpu_torch.utils.utils import Counter
from qserve_tpu_torch.worker.worker import Worker

logger = init_logger(__name__)


def step_kind(metadata, sched) -> Optional[str]:
    """What the scheduler emitted for one step: "prefill" (whole prompts or
    a long prompt's first chunk), "chunk" (a later chunk, or a prompt past
    its computed prefix, alone), "mixed" (a chunk with the decode batch
    riding along), "decode", or None when no model step runs."""
    if not metadata:
        return None
    if not sched.prompt_run:
        return "decode"
    if any(not md.is_prompt for md in metadata):
        return "mixed"
    if any(md.chunk is not None and md.chunk[0] > 0 for md in metadata):
        return "chunk"
    return "prefill"


class LLMEngine:
    def __init__(
        self,
        worker: Worker,
        scheduler_config: SchedulerConfig,
        cache_config: CacheConfig,
        tokenizer=None,
        log_stats: bool = False,
    ) -> None:
        self.worker = worker
        self.tokenizer = tokenizer
        self.scheduler = Scheduler(scheduler_config, cache_config)
        self.scheduler_config = scheduler_config
        self.cache_config = cache_config
        self.seq_counter = Counter()
        self.log_stats = log_stats
        if log_stats:
            tracing.enable()  # the log line reads the decode steps' spans
        self._step_no = 0
        # seq_id -> (group, seq) for O(1) result routing
        self._seq_index: Dict[int, Tuple[SequenceGroup, Sequence]] = {}
        self._num_generated = 0
        self.last_step_kind: Optional[str] = None
        self._num_prompt_tokens = 0
        # periodic stats emission (the reference plumbs log_stats/_LOGGING_
        # INTERVAL_SEC but never emits, llm_engine.py:44; here it is real)
        self._stats_interval_s = 10.0
        self._last_stats_time = time.time()
        self._last_stats_generated = 0
        self._last_stats_prompt = 0
        self._last_stats_span = -1
        self._last_stats_counters = self.scheduler.counters.as_dict()

    # ------------------------------------------------------------------
    @classmethod
    def from_engine_args(cls, engine_args) -> "LLMEngine":
        """Build an engine from EngineArgs (see engine/arg_utils.py)."""
        from qserve_tpu_torch.engine.arg_utils import EngineArgs

        assert isinstance(engine_args, EngineArgs)
        return engine_args.build_engine()

    # ------------------------------------------------------------------
    def add_request(
        self,
        request_id: str,
        prompt: Optional[str] = None,
        sampling_params: Optional[SamplingParams] = None,
        prompt_token_ids: Optional[List[int]] = None,
        arrival_time: Optional[float] = None,
        multi_modal_data: Optional[dict] = None,
        prefix_pos: Optional[int] = None,
    ) -> None:
        if sampling_params is None:
            sampling_params = SamplingParams()
        is_vlm_request = bool(multi_modal_data and multi_modal_data.get("images"))
        if prompt_token_ids is None:
            assert self.tokenizer is not None, "no tokenizer: pass prompt_token_ids"
            if is_vlm_request:
                from qserve_tpu_torch.models.vila import tokenizer_image_token

                prompt_token_ids = tokenizer_image_token(prompt, self.tokenizer)
            else:
                prompt_token_ids = self.tokenizer.encode(prompt)
        if sampling_params.use_beam_search:
            raise NotImplementedError("beam search not supported")
        if sampling_params.best_of > 1 and not getattr(
            self.worker.model_runner, "supports_multi_sample", False
        ):
            raise NotImplementedError(
                "n>1 / best_of>1 not supported by this model runner"
            )
        if is_vlm_request:
            # each image tag becomes tokens_per_image marker slots and the
            # images are preprocessed once, at admission (the scheduler then
            # counts pages and context exactly); only a request with
            # `images` expands, and given `pixel_values` skip preprocessing
            from qserve_tpu_torch.models.vila import expand_multimodal_prompt
            from qserve_tpu_torch.utils.image_processing import preprocess_images

            vila_args = getattr(self.worker.model_runner, "vila_args", None)
            assert vila_args is not None, "engine was not built with a VLM model"
            prompt_token_ids = expand_multimodal_prompt(
                prompt_token_ids, vila_args.tokens_per_image
            )
            if "pixel_values" not in multi_modal_data:
                multi_modal_data = dict(multi_modal_data)
                multi_modal_data["pixel_values"] = preprocess_images(
                    multi_modal_data["images"], vila_args.vision.image_size
                )

        seq = Sequence(
            next(self.seq_counter),
            prompt,
            prompt_token_ids,
            self.cache_config.block_size,
        )
        prefix = None
        if prefix_pos is not None:
            # shared-prompt page reuse (reference llm_engine prefix_pos arg)
            prefix = self.scheduler.prefix_pool.add_or_get_prefix(
                prompt_token_ids[:prefix_pos]
            )
        group = SequenceGroup(
            request_id, [seq], sampling_params, arrival_time, multi_modal_data,
            prefix=prefix,
        )
        self._seq_index[seq.seq_id] = (group, seq)
        self.scheduler.add_seq_group(group)

    def abort_request(self, request_id: str) -> None:
        self.scheduler.abort_seq_group([request_id])

    def has_unfinished_requests(self) -> bool:
        return self.scheduler.has_unfinished_seqs()

    def get_num_unfinished_requests(self) -> int:
        return self.scheduler.get_num_unfinished_seq_groups()

    # ------------------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        self._step_no += 1
        if not tracing.begin_step(self._step_no):
            outputs = self._step()
        else:
            with tracing.span("engine.step") as root:
                try:
                    outputs = self._step()
                finally:
                    root.kind = self.last_step_kind
        if self.log_stats:
            self._maybe_log_stats()
        return outputs

    def _step(self) -> List[RequestOutput]:
        with tracing.span("engine.schedule"):
            metadata, sched = self.scheduler.schedule()
        self.last_step_kind = step_kind(metadata, sched)
        if not metadata and not sched.ignored_seq_groups:
            if not sched.is_empty():
                with tracing.span("engine.execute"):
                    self.worker.execute_model([], sched)  # swaps only
            return []

        with tracing.span("engine.execute"):
            results = self.worker.execute_model(metadata, sched)
        with tracing.span("engine.post"):
            return self._post(metadata, sched, results)

    def _post(self, metadata, sched, results) -> List[RequestOutput]:
        """The step's outputs: prompt-token counts, appended tokens, forks,
        stop checks, freed sequences, RequestOutputs."""
        if sched.prompt_run:
            for md in metadata:
                if not md.is_prompt:
                    continue  # decode rows riding in a mixed chunk step
                for data in md.seq_data.values():
                    if md.chunk is not None:
                        self._num_prompt_tokens += md.chunk[1] - md.chunk[0]
                    else:
                        self._num_prompt_tokens += data.get_len()
            for group in sched.scheduled_seq_groups:
                if group.prefix is not None and all(
                    s.data.computed_tokens >= group.prefix.length
                    for s in group.get_seqs()
                    if not s.is_finished()
                ):
                    group.prefix.computed = True

        outputs: List[RequestOutput] = []
        touched_groups = []
        extra = getattr(self.worker.model_runner, "last_extra_samples", {})
        for seq_id, token in results:
            group, seq = self._seq_index[seq_id]
            if seq.status == SequenceStatus.WAITING:
                # non-final prefill chunk: its sampled token is meaningless
                # (the prompt continues); nothing to append yet
                touched_groups.append(group)
                continue
            seqs = [(seq, token)]
            if sched.prompt_run and group.sampling_params.best_of > 1:
                # fork the prompt into best_of candidates sharing its pages
                # (copy-on-write); each gets an independently sampled first
                # token (reference: sampling_params.py n/best_of + fork at
                # core/block_manager.py:227-233)
                for extra_token in extra.get(seq_id, []):
                    child = seq.fork(next(self.seq_counter))
                    self.scheduler.fork_seq(seq, child)
                    group.add(child)
                    self._seq_index[child.seq_id] = (group, child)
                    seqs.append((child, extra_token))
            for s, tok in seqs:
                s.append_token_id(tok)
                self._num_generated += 1
                self._check_stop(s, group.sampling_params)
                if s.is_finished():
                    self._finalize_sequence(s, group.sampling_params)
                    self.scheduler.free_seq(s)
            touched_groups.append(group)

        self.scheduler.free_finished_seq_groups()
        seen = set()
        for group in touched_groups:
            if id(group) in seen:
                continue
            seen.add(id(group))
            outputs.append(RequestOutput.from_seq_group(group))
        for group in sched.ignored_seq_groups:
            outputs.append(RequestOutput.from_seq_group(group))
        return outputs

    # ------------------------------------------------------------------
    def _check_stop(self, seq: Sequence, params: SamplingParams) -> None:
        last = seq.get_last_token_id()
        if not params.ignore_eos and self.tokenizer is not None:
            eos = getattr(self.tokenizer, "eos_token_id", None)
            if eos is not None and last == eos:
                seq.status = SequenceStatus.FINISHED_STOPPED
                return
        if last in params.stop_token_ids:
            seq.status = SequenceStatus.FINISHED_STOPPED
            return
        if seq.get_output_len() >= params.max_tokens:
            seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
            return
        if seq.get_len() >= self.scheduler_config.max_model_len:
            seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
            return
        if params.stop and self.tokenizer is not None:
            delta = self._detokenize_incrementally(seq, params)
            if not delta:
                return
            seq.output_text += delta
            # only the tail can contain a new match: the stop string must
            # overlap the freshly appended delta
            max_stop = max(len(s) for s in params.stop)
            start = max(0, len(seq.output_text) - len(delta) - max_stop + 1)
            for stop_str in params.stop:
                idx = seq.output_text.find(stop_str, start)
                if idx != -1:
                    seq.output_text = seq.output_text[:idx]
                    seq.status = SequenceStatus.FINISHED_STOPPED
                    return

    def _detokenize_incrementally(self, seq: Sequence, params: SamplingParams) -> str:
        """O(new tokens) per step via the token-string buffer on Sequence
        (prefix_offset / read_offset), instead of re-decoding the whole
        output every step. Multi-token characters are held back until the
        replacement char resolves."""
        tok = self.tokenizer
        if not hasattr(tok, "convert_ids_to_tokens") or not hasattr(
            tok, "convert_tokens_to_string"
        ):
            # fallback: full decode (rare tokenizers without the slow API)
            text = tok.decode(
                seq.data.output_token_ids,
                skip_special_tokens=params.skip_special_tokens,
            )
            delta = text[len(seq.output_text):] if text.startswith(seq.output_text) else text
            if not text.startswith(seq.output_text):
                seq.output_text = ""
            return delta
        if seq.tokens is None:
            # a few trailing prompt tokens give sentencepiece its context
            # (leading-space handling) without entering output_text
            ctx = seq.data.prompt_token_ids[-6:]
            seq.tokens = tok.convert_ids_to_tokens(ctx)
            seq.prefix_offset = max(len(seq.tokens) - 5, 0)
            seq.read_offset = len(seq.tokens)
        new_id = seq.get_last_token_id()
        if params.skip_special_tokens and new_id in getattr(tok, "all_special_ids", ()):
            return ""
        seq.tokens.extend(tok.convert_ids_to_tokens([new_id]))
        prefix_text = tok.convert_tokens_to_string(
            seq.tokens[seq.prefix_offset:seq.read_offset]
        )
        new_text = tok.convert_tokens_to_string(seq.tokens[seq.prefix_offset:])
        if new_text.endswith("�"):
            return ""  # partial multi-byte char; wait for more tokens
        delta = new_text[len(prefix_text):]
        seq.prefix_offset = seq.read_offset
        seq.read_offset = len(seq.tokens)
        return delta

    def _finalize_sequence(self, seq: Sequence, params: SamplingParams) -> None:
        if self.tokenizer is None:
            return
        if seq.status == SequenceStatus.FINISHED_STOPPED and params.stop:
            return  # output_text already trimmed at the stop string
        out_ids = list(seq.data.output_token_ids)
        if (
            seq.status == SequenceStatus.FINISHED_STOPPED
            and not params.ignore_eos
            and out_ids
            and out_ids[-1] == getattr(self.tokenizer, "eos_token_id", None)
        ):
            out_ids = out_ids[:-1]
        seq.output_text = self.tokenizer.decode(
            out_ids, skip_special_tokens=params.skip_special_tokens
        )

    # ------------------------------------------------------------------
    def _maybe_log_stats(self) -> None:
        now = time.time()
        dt = now - self._last_stats_time
        if dt < self._stats_interval_s:
            return
        gen = self._num_generated - self._last_stats_generated
        prompt = self._num_prompt_tokens - self._last_stats_prompt
        free = self.scheduler.block_manager.get_num_free_device_pages()
        total = self.scheduler.block_manager.num_device_pages
        logger.info(
            "throughput: %.1f gen tok/s, %.1f prompt tok/s | running %d, "
            "waiting %d, swapped %d | KV pages %.1f%% used",
            gen / dt, prompt / dt, len(self.scheduler.running),
            len(self.scheduler.waiting), len(self.scheduler.swapped),
            100.0 * (total - free) / max(total, 1),
        )
        # the interval's decode steps by host phase (spans), and its
        # scheduler events (counters)
        recent = tracing.spans(since=self._last_stats_span)
        steps, ms = tracing.step_means(recent, tracing.DECODE_PHASES)
        counters = self.scheduler.counters.as_dict()
        d = {k: v - self._last_stats_counters[k] for k, v in counters.items()}
        waits = [s.duration_ns for s in recent if s.name == "request.queue"]
        logger.info(
            "decode step host ms (%d steps): schedule %.2f, cache ops %.2f, "
            "pack %.2f, forward %.2f, sample %.2f, read-back %.2f, post %.2f | "
            "preempted %d by recompute, %d by swap | pages swapped out %d, "
            "in %d | queue wait mean %.1f ms, max %.1f ms (%d admitted)",
            steps, *(ms[n] for n in tracing.DECODE_PHASES),
            d["preempted_recompute"], d["preempted_swap"],
            d["pages_swapped_out"], d["pages_swapped_in"],
            d["queue_wait_ns_sum"] / 1e6 / max(d["admitted"], 1),
            max(waits, default=0) / 1e6, d["admitted"],
        )
        self._last_stats_time = now
        self._last_stats_generated = self._num_generated
        self._last_stats_prompt = self._num_prompt_tokens
        self._last_stats_span = max((s.id for s in recent), default=self._last_stats_span)
        self._last_stats_counters = counters

    def stats(self) -> dict:
        """The engine's totals and queues, the scheduler's event counters
        (utils/tracing.Counters), the model runner's decode steps by how
        their forward ran (utils/tracing.DecodeCounters) and the running
        totals of the process's counters (utils/tracing.count: the MoE
        rows, the KV slots held and those below a layer's window)."""
        return dict(
            generated_tokens=self._num_generated,
            prompt_tokens=self._num_prompt_tokens,
            free_pages=self.scheduler.block_manager.get_num_free_device_pages(),
            waiting=len(self.scheduler.waiting),
            running=len(self.scheduler.running),
            swapped=len(self.scheduler.swapped),
            **self.scheduler.counters.as_dict(),
            **self.worker.model_runner.decode_counts.as_dict(),
            **tracing.totals(),
        )
