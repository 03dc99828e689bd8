"""One run of one cell: build the engine, drive its traffic through
`LLMEngine.step()`, and record every step and request on the host clock.

The engine is the program's normal serving path: the scheduler's defaults
(chunked prefill, mixed chunk + decode steps), the device feed off, so
every step samples real ids and reads them back. Its weights are the
benchmark's own (qbench/weights.py), laid out by the configuration's model
family (qbench/families/) and handed over as a float checkpoint is: the
family's `quantize_params`, then `Worker.create(params=...)`.

Besides the tokens, the harness reads only what the engine shows its
callers: each step's outputs, `last_step_kind`, `stats()` and the kernel
launch counter (`kernels/_build.LAUNCHES`). From those it keeps, for each
request, the step times of its tokens and the spans of its prompt that
each prompt step computed, which the reference needs (a KV4 cache makes
attention depend on which positions shared a step).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from qbench.traffic import RequestSpec, Traffic
from qbench.weights import WeightMaker, derive_seed

PROMPT_KINDS = ("prefill", "chunk", "mixed")
DECODE_KINDS = ("decode", "mixed")


@dataclasses.dataclass
class Request:
    spec: RequestSpec
    rid: str
    due: float  # host clock: when it was due (open loop) or sent (closed)
    first: Optional[float] = None  # end of the step that returned its first token
    last: Optional[float] = None
    done: Optional[float] = None
    n_out: int = 0
    computed: int = 0  # prompt positions computed so far
    chunk_ends: List[int] = dataclasses.field(default_factory=list)
    tokens: Optional[List[int]] = None
    reason: Optional[str] = None
    irregular: bool = False  # its prompt spans could not be followed

    @property
    def prompt_len(self) -> int:
        return len(self.spec.prompt)

    @property
    def failed(self) -> bool:
        return self.done is not None and (self.reason == "abort" or self.n_out < self.spec.max_tokens)


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    kind: str
    launches: int
    decode_ctx: List[int]  # each decode row's context, its current token included
    spans: List[tuple]  # (start, end) of each prompt span computed
    logit_rows: int
    new_tokens: int
    pages_used: int  # KV pages held once the step returned


def build_engine(family, cfg: dict, seed: int, device, args=None,
                 num_pages: Optional[int] = None):
    """The engine of a configuration, served as its model family's program
    says, its weights made from `seed` on `device` and quantized there; the
    KV cache takes the configuration's share of the memory the weights
    leave (or `num_pages`). `args` replaces the program's (small CPU tests
    change its MoE routing)."""
    from qserve_tpu_torch.config import CacheConfig, SchedulerConfig
    from qserve_tpu_torch.engine.arg_utils import auto_num_pages
    from qserve_tpu_torch.engine.llm_engine import LLMEngine
    from qserve_tpu_torch.worker.worker import Worker

    s = cfg["serving"]
    prog = family.program(cfg)
    args = args or prog.args
    maker = WeightMaker(seed, cfg, device, family.sizes(cfg))
    params = prog.quantize(family.float_params(maker), args, device=device)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the float tensors' blocks go back to the card
    cache_config = CacheConfig(block_size=s["page_size"], quant=args.quant,
                               gpu_memory_utilization=s["kv_cache_memory_fraction"],
                               **prog.cache)
    sched = SchedulerConfig(max_num_batched_tokens=s["max_num_batched_tokens"],
                            max_num_seqs=s["max_num_seqs"], max_model_len=s["max_model_len"])
    cache_config.num_device_pages = num_pages or auto_num_pages(
        args, cache_config, s["kv_cache_memory_fraction"], device)
    worker = Worker.create(args, cache_config, sched, params=params,
                           seed=derive_seed(seed, "sampler") >> 2, device=device,
                           benchmarking=False)
    return LLMEngine(worker, sched, cache_config, tokenizer=None)


def launch_total() -> int:
    from qserve_tpu_torch.kernels import _build

    return sum(_build.LAUNCHES.values())


class Feeder:
    """Feeds one engine its traffic and records steps and requests."""

    def __init__(self, engine, traffic: Traffic, clock=time.perf_counter) -> None:
        self.engine = engine
        self.traffic = traffic
        self.clock = clock
        self.requests: Dict[str, Request] = {}
        self.steps: List[Step] = []
        self.span = None  # callable(name) -> context manager, while traced
        self._prompt_tokens = engine.stats()["prompt_tokens"]
        self.kv_pages = engine.cache_config.num_device_pages
        self._pending: List[RequestSpec] = []
        self._epochs = None
        self.sched0: Optional[float] = None

    # ---- sending -------------------------------------------------------
    def _send(self, spec: RequestSpec, due: float) -> None:
        from qserve_tpu_torch.sampling_params import SamplingParams

        rid = str(spec.index)
        self.requests[rid] = Request(spec=spec, rid=rid, due=due)
        sp = SamplingParams(temperature=spec.temperature, top_p=spec.top_p,
                            max_tokens=spec.max_tokens, ignore_eos=True)
        self.engine.add_request(rid, sampling_params=sp,
                                prompt_token_ids=spec.prompt.tolist(), arrival_time=due)

    def warm_shapes(self) -> None:
        """Run the mix's shape warm-up requests to completion, together."""
        budget = self.engine.scheduler_config.max_num_batched_tokens
        for spec in self.traffic.shape_warmup(budget):
            self._send(spec, self.clock())
        while self.engine.has_unfinished_requests():
            self.step()

    def start(self) -> None:
        """Start the schedule: a closed loop sends every client's first
        request; an open loop fixes the time its arrivals count from."""
        self.sched0 = self.clock()
        if self.traffic.loop == "closed":
            for spec in self.traffic.initial_requests():
                self._send(spec, self.sched0)
        else:
            self._epochs = self.traffic.epochs()

    def _admit_due(self, now: float) -> Optional[float]:
        """Open loop: send what is due; returns when the next one is due."""
        while True:
            if not self._pending:
                self._pending = list(next(self._epochs))
                self._pending.reverse()
            due = self.sched0 + self._pending[-1].due
            if due > now:
                return due
            self._send(self._pending.pop(), due)

    # ---- stepping ------------------------------------------------------
    def run(self, until: Optional[float] = None, steps: Optional[int] = None,
            while_: Optional[Callable[[], bool]] = None) -> None:
        """Step until the clock passes `until`, `steps` steps have run, or
        while_() turns false."""
        n = 0
        while True:
            now = self.clock()
            if until is not None and now >= until:
                return
            if steps is not None and n >= steps:
                return
            if while_ is not None and not while_():
                return
            if self.traffic.loop == "open":
                nxt = self._admit_due(now)
                if not self.engine.has_unfinished_requests():
                    wake = nxt if until is None else min(nxt, until)
                    self._wait(wake - now)
                    continue
            if self.step() is not None:
                n += 1

    def _wait(self, seconds: float) -> None:
        if seconds <= 0:
            return
        if self.span is None:
            time.sleep(seconds)
        else:
            with self.span("qbench.wait"):
                time.sleep(seconds)

    def step(self) -> Optional[Step]:
        eng = self.engine
        l0 = launch_total()
        t0 = self.clock()
        if self.span is None:
            outs = eng.step()
        else:
            with self.span("qbench.step"):
                outs = eng.step()
        t1 = self.clock()
        kind = eng.last_step_kind
        launches = launch_total() - l0
        stats = eng.stats()
        prompt_reqs: List[Request] = []
        decode_ctx: List[int] = []
        new_tokens = 0
        finished: List[Request] = []
        firsts: List[Request] = []
        for o in outs:
            r = self.requests[o.request_id]
            out = o.outputs[0] if o.outputs else {"token_ids": [], "finish_reason": None}
            toks = out["token_ids"]
            if kind in PROMPT_KINDS and r.n_out == 0:
                prompt_reqs.append(r)
            elif kind in DECODE_KINDS:
                decode_ctx.append(r.prompt_len + r.n_out)
            n = len(toks)
            if n > r.n_out:
                new_tokens += n - r.n_out
                if r.first is None:
                    r.first = t1
                    firsts.append(r)
                r.last = t1
                r.n_out = n
            if o.finished:
                r.done, r.reason, r.tokens = t1, out["finish_reason"], list(toks)
                finished.append(r)
        if kind in PROMPT_KINDS:
            spans = self._prompt_spans(prompt_reqs, stats["prompt_tokens"])
        else:
            self._prompt_tokens, spans = stats["prompt_tokens"], []
        for r in firsts:
            if r.computed != r.prompt_len:
                r.irregular = True
        if kind is None:
            st = None
        else:
            logit_rows = {"prefill": len(prompt_reqs), "chunk": 1}.get(kind, 0) + len(decode_ctx)
            if kind == "mixed":
                logit_rows += 1
            st = Step(t0, t1, kind, launches, decode_ctx, spans, logit_rows, new_tokens,
                      self.kv_pages - stats["free_pages"])
            self.steps.append(st)
        if self.traffic.loop == "closed":
            for r in finished:
                if r.spec.client is not None:
                    self._send(self.traffic.next_request(r.spec.client), self.clock())
        return st

    def _prompt_spans(self, prompt_reqs: List[Request], pt: int) -> List[tuple]:
        """The prompt spans a step computed, from the growth of the engine's
        prompt-token count: one request takes all of it (a chunk, or a
        whole prompt); several are whole prompts from their start (the
        scheduler chunks only a prompt that runs alone). Anything else (a
        preempted request computed again) marks the step's requests as
        irregular: the reference cannot follow them."""
        delta, self._prompt_tokens = pt - self._prompt_tokens, pt
        if len(prompt_reqs) == 1:
            r = prompt_reqs[0]
            spans = [(r.computed, r.computed + delta)]
        else:
            spans = [(0, r.prompt_len) for r in prompt_reqs]
        ok = (sum(e - s for s, e in spans) == delta
              and all(s == r.computed and e <= r.prompt_len
                      for (s, e), r in zip(spans, prompt_reqs)))
        if not ok:
            for r in self.requests.values():
                if r.done is None:
                    r.irregular = True
            return spans
        for (s, e), r in zip(spans, prompt_reqs):
            r.computed = e
            r.chunk_ends.append(e)
        return spans


def memory_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free_engine(engine) -> None:
    """Drop the program's state (weights, KV cache) before the reference."""
    runner = engine.worker.model_runner
    runner.params = None
    engine.worker.cache_engine.cache = None
    del runner
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def window_requests(feeder: Feeder, t0: float, t1: float) -> List[Request]:
    """Requests due inside [t0, t1)."""
    return [r for r in feeder.requests.values() if t0 <= r.due < t1]


def finished_in(feeder: Feeder, t0: float, t1: float) -> List[Request]:
    return [r for r in feeder.requests.values()
            if r.done is not None and t0 <= r.done <= t1]
