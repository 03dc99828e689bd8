"""Model runner: marshals scheduler output into prefill, chunk, mixed
chunk+decode and decode steps (qserve_tpu/worker/model_runner.py).

Shapes are bucketed as in the JAX package (prefill and chunk tokens to a
power of two >= 16, decode batch to a power of two), so the kernels see the
same padded shapes. Sampling runs on the device; only the sampled ids [B]
cross back. A chunk's start is a host integer and reaches the attention
kernel as a scalar argument, never through a device read. Host inputs
reach the card from pinned staging copies (utils.to_device), so no copy
waits for the card's queue.

Every step path times its host phases (utils/tracing.py): `runner.pack`
(the metadata walk, the native pack and the staging copies),
`runner.forward` (the model call: the host issuing the layers and the
lm_head), `runner.sample` and `runner.readback` (the host blocked on the
sampled ids).

On CUDA at tp_size 1, a decode step replays a CUDA graph of `llama.decode`
(`DecodeGraph`) in place of issuing its ~300-1000 launches one by one: one
graph per padded batch, captured over the KV cache once it exists
(`capture_decode_graphs`), largest first into one memory pool. The step's
inputs are copied into the graph's static buffers, its block table packed
at the full `max_pages_per_seq` width so that one graph serves every
history; sampling stays outside the graph. Prefill, chunk and mixed steps,
tensor parallelism and the CPU issue eagerly, as does a decode batch with
no graph. `decode_counts` counts the two kinds of decode step, and a
replay runs inside its own span, `runner.graph_replay`.

With `benchmarking` (the JAX package's device-feed mode), a decode step
whose batch has the same sequences in the same order and width as the
decode step before takes that step's sampled ids, still on the device, as
its input tokens, and returns placeholder ids (0) without reading them
back: the host queues step n+1 while the card runs step n. Prefill, chunk
and mixed steps return real ids; a mixed step ends the feed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from qserve_tpu_torch import native
from qserve_tpu_torch.kernels import _build
from qserve_tpu_torch.layers import sampler as sampler_mod
from qserve_tpu_torch.models import llama
from qserve_tpu_torch.sequence import SequenceGroupMetadata
from qserve_tpu_torch.utils import tracing
from qserve_tpu_torch.utils.utils import bucket, resolve_device, to_device

_SAMPLING_EPS = 1e-5


def _cache_ptrs(cache) -> tuple:
    """Where the KV cache's tensors live: a graph records these pointers."""
    return cache.data.data_ptr(), cache.scales.data_ptr()


class DecodeGraph:
    """One CUDA graph of the decode forward at a padded batch B: the static
    inputs (tokens [B], block tables [B, maxP], context lens [B]) each step
    is copied into, the logits [B, V] a replay writes, and the port's
    launches and the counter samples the capture recorded
    (kernels/_build.LAUNCHES, utils/tracing.count), made again by each
    replay."""

    def __init__(self, B: int, max_pages: int, device) -> None:
        self.inputs = (
            torch.zeros(B, dtype=torch.int32, device=device),
            torch.zeros((B, max_pages), dtype=torch.int32, device=device),
            torch.zeros(B, dtype=torch.int32, device=device),
        )
        self.graph = None
        self.logits: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}

    def load(self, tok: np.ndarray, bt: np.ndarray, cl: np.ndarray) -> None:
        """A step's packed host arrays into the static inputs, on CUDA
        through pinned staging copies (utils.to_device's reason)."""
        for dst, a in zip(self.inputs, (tok, bt, cl)):
            x = torch.from_numpy(a)
            dst.copy_(x.pin_memory() if dst.is_cuda else x, non_blocking=True)

    def capture(self, forward, pool, stream) -> None:
        """Record forward() -> logits over the static inputs, after one
        eager warm-up of it on the capture stream (all rows padding: ctx 0,
        so the warm-up writes nothing to the cache)."""
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            forward()
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with _build.captured_launches() as self.launches, \
                tracing.captured_counts() as self.counts:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.logits = forward()

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        _build.LAUNCHES.update(self.launches)
        tracing.replay_counts(self.counts)
        return self.logits


def sample_host(
    logits: np.ndarray, sp, rng: np.random.Generator, count: int
) -> List[int]:
    """Draw `count` tokens from one logits row with sp's temperature /
    top-k / top-p on the host (only for the extra best_of candidates of a
    prompt, off the hot path)."""
    logits = np.asarray(logits, np.float64)
    if sp.temperature < _SAMPLING_EPS:
        return [int(np.argmax(logits))] * count
    scaled = logits / sp.temperature
    V = scaled.shape[0]
    if sp.top_k not in (-1, 0) and sp.top_k < V:
        kth = np.partition(scaled, -sp.top_k)[-sp.top_k]
        scaled = np.where(scaled >= kth, scaled, -np.inf)
    if sp.top_p < 1.0:
        order = np.argsort(scaled)[::-1]
        probs = np.exp(scaled[order] - np.max(scaled))
        probs /= probs.sum()
        keep = (np.cumsum(probs) - probs) < sp.top_p
        thresh = np.min(np.where(keep, scaled[order], np.inf))
        scaled = np.where(scaled >= thresh, scaled, -np.inf)
    p = np.exp(scaled - np.max(scaled))
    p /= p.sum()
    return [int(t) for t in rng.choice(V, size=count, p=p)]


class ModelRunner:
    """Holds model params and runs the prefill / decode steps."""

    # n>1 / best_of>1 prompts: extra candidates host-sampled from the
    # prefill logits
    supports_multi_sample = True

    def __init__(
        self,
        params: llama.LlamaParams,
        model_args: llama.LlamaArgs,
        max_model_len: int,
        block_size: int,
        max_num_batched_tokens: int = 2048,
        max_num_seqs: int = 256,
        rng_seed: int = 0,
        device="cuda",
        benchmarking: bool = False,
    ) -> None:
        self.device = resolve_device(device)
        self.params = params
        self.model_args = model_args
        self.block_size = block_size
        self.max_pages_per_seq = -(-max_model_len // block_size)
        self.max_num_batched_tokens = max_num_batched_tokens
        self.max_num_seqs = max_num_seqs
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        # host generator of the filtered-sampling kernel's (seed, offset):
        # drawing them reads nothing from the device
        self.seed_generator = torch.Generator(device="cpu").manual_seed(rng_seed)
        self._host_rng = np.random.default_rng(rng_seed + 1)
        # seq_id -> extra candidate tokens from the latest prefill (best_of>1)
        self.last_extra_samples: Dict[int, List[int]] = {}
        # device feed: the last decode step's sequence order and sampled ids
        self.benchmarking = benchmarking
        self._prev_order: Optional[tuple] = None
        self._prev_toks: Optional[torch.Tensor] = None
        # padded B -> its decode graph, and the cache pointers they hold
        self._graphs: Dict[int, DecodeGraph] = {}
        self._graph_cache: Optional[tuple] = None
        # decode steps by how the forward ran (LLMEngine.stats() returns them)
        self.decode_counts = tracing.DecodeCounters()
        # the batch marshal: built (or found built) here, so a failed g++
        # build raises at construction and no step pays for the compile
        native.get_lib()

    @classmethod
    def from_random(
        cls,
        model_args: llama.LlamaArgs,
        max_model_len: int,
        block_size: int,
        seed: int = 0,
        device="cuda",
        **kw,
    ) -> "ModelRunner":
        params = llama.random_quantized_params(seed, model_args, device=device)
        return cls(params, model_args, max_model_len, block_size,
                   rng_seed=seed, device=device, **kw)

    # ------------------------------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return to_device(torch.from_numpy(a), self.device)

    @staticmethod
    def _sampling_arrays(per_seq_params, pad_to: int):
        """Host tensors (temperature, top_p, top_k) [pad_to]."""
        temp = np.zeros(pad_to, np.float32)
        topp = np.ones(pad_to, np.float32)
        topk = np.zeros(pad_to, np.int32)
        for i, sp in enumerate(per_seq_params):
            temp[i] = 0.0 if sp.temperature < _SAMPLING_EPS else sp.temperature
            topp[i] = sp.top_p
            topk[i] = 0 if sp.top_k in (-1, 0) else sp.top_k
        return torch.from_numpy(temp), torch.from_numpy(topp), torch.from_numpy(topk)

    def _sample(self, logits, sp_list, pad_to) -> torch.Tensor:
        with tracing.span("runner.sample"):
            temp, topp, topk = self._sampling_arrays(sp_list, pad_to)
            return sampler_mod.sample(
                logits, temp, topp, topk, self.generator,
                seed_generator=self.seed_generator,
            )

    def _read_back(self, toks, seq_order, logits=None, sp_list=None,
                   completes=None) -> List[Tuple[int, int]]:
        """[(seq_id, sampled id)] of the step's rows; given the logits, the
        extra best_of candidates of each prompt the step completes
        (`last_extra_samples`) are drawn from their read-back rows."""
        with tracing.span("runner.readback"):
            self.last_extra_samples = {}
            if logits is not None:
                for i, (sid, sp) in enumerate(zip(seq_order, sp_list)):
                    if sp.best_of > 1 and completes[i]:
                        self.last_extra_samples[sid] = self._extra_samples(logits[i], sp)
            out = toks.cpu().numpy()
        return [(sid, int(out[i])) for i, sid in enumerate(seq_order)]

    def _extra_samples(self, logits_row, sp) -> List[int]:
        """best_of - 1 more first tokens of a completed prompt, host-sampled
        from its last-token logits."""
        return sample_host(
            logits_row.float().cpu().numpy(), sp, self._host_rng, sp.best_of - 1
        )

    def _pack_prefill(self, metadata: List[SequenceGroupMetadata]):
        """(seq ids, their sampling params, whether this step completes each
        prompt, device (tok, pos, seg, pages, slots, last_idx), padded batch
        B) of a batch of whole prompts or a long prompt's first chunk."""
        prompts: List[List[int]] = []
        tables: List[List[int]] = []
        seq_order: List[int] = []
        sp_list = []
        completes: List[bool] = []  # this step finishes the prompt
        for md in metadata:
            for seq_id, data in md.seq_data.items():
                ids = data.get_token_ids()
                if md.chunk is not None:  # first chunk of a long prompt
                    ids = ids[md.chunk[0] : md.chunk[1]]
                completes.append(md.chunk is None or md.chunk[1] >= data.get_len())
                prompts.append(ids)
                tables.append(md.block_tables[seq_id])
                seq_order.append(seq_id)
                sp_list.append(md.sampling_params)

        total = sum(len(p) for p in prompts)
        T = bucket(total, 16, self.max_num_batched_tokens * 2)
        B = bucket(len(seq_order), 1, self.max_num_seqs)
        tok, pos, sg, pg, sl, _, li, _ = native.pack_prefill(
            prompts, tables, self.block_size, T, B
        )
        packed = tuple(map(self._dev, (tok, pos, sg, pg, sl, li)))
        return seq_order, sp_list, completes, packed, B

    def _pack_chunk(self, md: SequenceGroupMetadata):
        """Device inputs of one chunk [start, end) of one prompt:
        (seq_id, start, end, prompt_len, (tok, pos, seg, pages, slots,
        last_idx), block table [1, maxP])."""
        (seq_id, data), = md.seq_data.items()
        start, end = md.chunk
        ids = data.get_token_ids()[start:end]
        table = md.block_tables[seq_id]
        T = bucket(len(ids), 16, self.max_num_batched_tokens * 2)
        tok, pos, sg, pg, sl, _, li, _ = native.pack_prefill(
            [ids], [table], self.block_size, T, 1, starts=[start]
        )
        bt = np.zeros((1, self.max_pages_per_seq), np.int32)
        bt[0, : len(table)] = table
        packed = tuple(map(self._dev, (tok, pos, sg, pg, sl, li)))
        return seq_id, start, end, data.get_len(), packed, self._dev(bt)

    # ------------------------------------------------------------------
    def execute_prefill(
        self,
        metadata: List[SequenceGroupMetadata],
        cache_engine,
    ) -> List[Tuple[int, int]]:
        """Returns [(seq_id, sampled_token)] in schedule order."""
        if any(md.chunk is not None and md.chunk[0] > 0 for md in metadata):
            # prefix-continuation step (chunked prefill / prefix skip): the
            # scheduler emits these alone (one sequence)
            assert len(metadata) == 1
            return self._execute_prefill_chunk(metadata[0], cache_engine)

        with tracing.span("runner.pack"):
            seq_order, sp_list, completes, packed, B = self._pack_prefill(metadata)
        with tracing.span("runner.forward"):
            logits, cache_engine.cache = llama.prefill(
                self.params, cache_engine.cache, *packed, self.model_args,
            )
        toks = self._sample(logits, sp_list, B)
        return self._read_back(toks, seq_order, logits, sp_list, completes)

    # ------------------------------------------------------------------
    def _execute_prefill_chunk(
        self, md: SequenceGroupMetadata, cache_engine
    ) -> List[Tuple[int, int]]:
        """One chunk of one prompt whose prefix KV is already cached."""
        with tracing.span("runner.pack"):
            seq_id, start, end, prompt_len, packed, bt = self._pack_chunk(md)
        with tracing.span("runner.forward"):
            logits, cache_engine.cache = llama.prefill_chunk(
                self.params, cache_engine.cache, *packed, bt, start, self.model_args
            )
        sp = md.sampling_params
        toks = self._sample(logits, [sp], 1)
        # the final chunk of an n>1 prompt host-samples the extra candidates
        return self._read_back(toks, [seq_id], logits, [sp], [end == prompt_len])

    # ------------------------------------------------------------------
    def execute_chunk_with_decode(
        self,
        chunk_md: SequenceGroupMetadata,
        decode_mds: List[SequenceGroupMetadata],
        cache_engine,
    ) -> List[Tuple[int, int]]:
        """Mixed step: one prefill chunk + the running decode batch in a
        single [T+B] forward, so running sequences keep generating while a
        long prompt admits."""
        with tracing.span("runner.pack"):
            seq_id, start, _, _, packed, bt = self._pack_chunk(chunk_md)
            d_order, d_sps, d_packed, B = self._pack_decode(decode_mds)
        with tracing.span("runner.forward"):
            logits, cache_engine.cache = llama.prefill_chunk_with_decode(
                self.params, cache_engine.cache, *packed, bt, start, *d_packed,
                self.model_args,
            )
        toks = self._sample(logits, [chunk_md.sampling_params] + d_sps, 1 + B)
        self._prev_order = None  # the decode rows advanced outside execute_decode
        return self._read_back(toks, [seq_id] + d_order)

    # ------------------------------------------------------------------
    def graph_buckets(self) -> List[int]:
        """Every padded decode batch: what bucket(n, 1, max_num_seqs) gives."""
        out, b = [], 1
        while b < self.max_num_seqs:
            out.append(b)
            b *= 2
        return out + [self.max_num_seqs]

    def capture_decode_graphs(self, cache_engine) -> None:
        """One CUDA graph of `llama.decode` per padded decode batch over
        this cache, largest first into one memory pool. Only on CUDA at
        tp_size 1: elsewhere every decode step issues eagerly. The graphs
        hold the cache's and the parameters' device pointers; every step
        updates the cache's tensors in place and no step replaces the
        parameters, and a step that finds other cache tensors raises
        (`_decode_graph`)."""
        self._graphs = {}
        if self.device.type != "cuda" or self.model_args.tp_size != 1:
            return
        self._graph_cache = _cache_ptrs(cache_engine.cache)
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(self.device)
        for B in sorted(self.graph_buckets(), reverse=True):
            g = DecodeGraph(B, self.max_pages_per_seq, self.device)
            g.capture(lambda g=g: llama.decode(
                self.params, cache_engine.cache, *g.inputs, self.model_args)[0],
                pool, stream)
            self._graphs[B] = g

    def _decode_graph(self, metadata, cache_engine) -> Optional[DecodeGraph]:
        """The graph of this decode batch's padded B, or None: the step
        issues eagerly."""
        if self._graphs and _cache_ptrs(cache_engine.cache) != self._graph_cache:
            raise RuntimeError("the KV cache's tensors are not those the decode "
                               "graphs were captured over")
        rows = sum(len(md.seq_data) for md in metadata)
        return self._graphs.get(bucket(rows, 1, self.max_num_seqs))

    def _pack_decode(self, metadata: List[SequenceGroupMetadata],
                     graph: Optional[DecodeGraph] = None):
        """(seq ids, their sampling params, device (tokens, block tables,
        context lens), padded batch B) of a decode batch. Given the step's
        graph, the inputs are its static buffers, the table max_pages_per_seq
        wide."""
        seq_order: List[int] = []
        tokens: List[int] = []
        ctx: List[int] = []
        tables: List[List[int]] = []
        sp_list = []
        for md in metadata:
            for seq_id, data in md.seq_data.items():
                seq_order.append(seq_id)
                tokens.append(data.get_last_token_id())
                ctx.append(data.get_len())
                tables.append(md.block_tables[seq_id])
                sp_list.append(md.sampling_params)
        B = bucket(len(seq_order), 1, self.max_num_seqs)
        if graph is not None:
            tok, cl, bt = native.pack_decode(tokens, ctx, tables, B, self.max_pages_per_seq)
            graph.load(tok, bt, cl)
            return seq_order, sp_list, graph.inputs, B
        # the table only as wide as the batch's longest history: K4 sizes its
        # split of each history by that width
        width = min(-(-max(ctx, default=1) // self.block_size), self.max_pages_per_seq)
        tok, cl, bt = native.pack_decode(tokens, ctx, tables, B, max(width, 1))
        return seq_order, sp_list, tuple(map(self._dev, (tok, bt, cl))), B

    # ------------------------------------------------------------------
    def execute_decode(
        self,
        metadata: List[SequenceGroupMetadata],
        cache_engine,
    ) -> List[Tuple[int, int]]:
        with tracing.span("runner.pack"):
            graph = self._decode_graph(metadata, cache_engine)
            seq_order, sp_list, packed, B = self._pack_decode(metadata, graph)
            order = tuple(seq_order)
            if (self.benchmarking and self._prev_order == order
                    and self._prev_toks is not None and self._prev_toks.shape[0] == B):
                if graph is None:
                    packed = (self._prev_toks,) + packed[1:]
                else:
                    packed[0].copy_(self._prev_toks)
        with tracing.span("runner.forward"):
            if graph is None:
                logits, cache_engine.cache = llama.decode(
                    self.params, cache_engine.cache, *packed, self.model_args
                )
                self.decode_counts.decode_eager_steps += 1
            else:
                with tracing.span("runner.graph_replay"):
                    logits = graph.replay()
                self.decode_counts.decode_graph_replays += 1
        toks = self._sample(logits, sp_list, B)
        if self.benchmarking:
            self.last_extra_samples = {}
            self._prev_order, self._prev_toks = order, toks
            # placeholder ids: benchmark mode never reads the values back
            return [(sid, 0) for sid in seq_order]
        return self._read_back(toks, seq_order)
