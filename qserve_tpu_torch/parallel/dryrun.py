"""The multi-chip dryrun and the rank programs of the TP port
(__graft_entry__.py dryrun_multichip, scripts/dryrun_multihost.py).

`dryrun_multichip(n)` spawns n ranks on the CPU as dp = n / 2 replicas of
tp = 2 at the JAX dryrun's toy geometry; each replica serves one sampled
prompt (a prefill and decode steps) through EngineArgs, and the ranks of
each replica must give the same stream. The JAX package has two dryruns:
one SPMD program over a (dp, tp) mesh, and two processes that run the same
replicated engine over a mesh spanning both. One process per rank *is* the
multi-host layout: a rank neither knows nor needs to know whether its peers
share its host (torchrun sets the same environment either way), so this one
dryrun covers both.

The other functions are rank programs that the tests and chip_smoke.py
start with `distributed.spawn`: fn(rank, world_size, ...) -> a picklable
result. They import neither JAX nor the JAX package; the tests compute the
JAX side in their own process and compare.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

# __graft_entry__.py _flagship_args(small=True): the JAX dryrun's geometry
TOY = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
           num_attention_heads=8, num_key_value_heads=4, head_dim=32)


def setup_rank(tp: int, dp: int = 1, device="cpu"):
    """One thread a rank (many ranks share the host's cores), then the
    process group from the environment `spawn` set."""
    import torch

    from qserve_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    return distributed.init_distributed(tp, dp, device=device)


def dryrun_rank(rank: int, world_size: int) -> dict:
    from qserve_tpu_torch.engine.arg_utils import EngineArgs
    from qserve_tpu_torch.sampling_params import SamplingParams

    tp = 2
    tp_rank, _, dev = setup_rank(tp, world_size // tp)
    engine = EngineArgs(
        hf_config=TOY, random_weights=True, seed=0, device=str(dev),
        tensor_parallel_size=tp, block_size=16, num_device_pages=8,
        max_num_batched_tokens=128, max_num_seqs=4, max_model_len=128,
    ).build_engine()
    replica = rank // tp
    prompt = list(range(1 + replica, 8 + replica))  # 7 tokens, one a replica
    engine.add_request("r", prompt_token_ids=prompt, sampling_params=SamplingParams(
        max_tokens=4, temperature=0.7, top_p=0.9, ignore_eos=True))
    kinds = []
    tokens = None
    while engine.has_unfinished_requests():
        for out in engine.step():
            if out.finished:
                tokens = list(out.outputs[0]["token_ids"])
        kinds.append(engine.last_step_kind)
    return dict(rank=rank, replica=replica, tp_rank=tp_rank, tokens=tokens, kinds=kinds)


def dryrun_multichip(n_devices: int, timeout_s: float = 240.0) -> List[dict]:
    """n_devices ranks on the CPU, dp = n_devices / 2 x tp = 2: each replica
    serves one sampled prompt; each replica's TP ranks must agree."""
    from qserve_tpu_torch.parallel import distributed

    assert n_devices % 2 == 0 and n_devices >= 2, n_devices
    out = distributed.spawn(dryrun_rank, n_devices, timeout_s=timeout_s)
    for r in out:
        assert r["tokens"] is not None and len(r["tokens"]) == 4, r
        assert r["kinds"][0] == "prefill" and "decode" in r["kinds"], r
        mate = out[r["replica"] * 2]
        assert r["tokens"] == mate["tokens"], (r, mate)
    streams = {r["replica"]: r["tokens"] for r in out}
    print(f"dryrun_multichip OK: {n_devices} ranks, dp {n_devices // 2} x tp 2, "
          f"replica streams {streams}", flush=True)
    return out


# ---------------------------------------------------------------------------
# rank programs of the tests
# ---------------------------------------------------------------------------


def make_args(spec: dict):
    """LlamaArgs of a picklable spec: geometry fields, `quant` as the
    QuantSpec's fields."""
    from qserve_tpu_torch.config import QuantSpec
    from qserve_tpu_torch.models import llama

    spec = dict(spec)
    return llama.LlamaArgs(quant=QuantSpec(**spec.pop("quant")), **spec)


def _float_params(fp):
    """numpy float weights -> CPU tensors (the structure kept)."""
    import torch

    if isinstance(fp, dict):
        return {k: _float_params(v) for k, v in fp.items()}
    if isinstance(fp, list):
        return [_float_params(v) for v in fp]
    return torch.from_numpy(np.array(fp, np.float32))


def _np(t):
    import torch

    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def logits_rank(rank: int, world_size: int, cases: List[dict]) -> Dict[str, dict]:
    """Each case: `args` (make_args spec), `fp` (numpy float weights, the JAX
    package's layout), `prefill` (tok, pos, seg, pages, slots, last),
    `decode` (tok, block tables, context lens), `pages`, `page_size`.
    Returns per case this rank's prefill and decode logits."""
    import dataclasses

    import torch

    from qserve_tpu_torch.kernels import kv_cache as kvc
    from qserve_tpu_torch.models import llama
    from qserve_tpu_torch.parallel import tp as tpmod

    tp_rank, _, dev = setup_rank(world_size)
    out = {}
    for case in cases:
        args = dataclasses.replace(make_args(case["args"]), tp_size=world_size)
        params = tpmod.quantize_params_tp(_float_params(case["fp"]), args, tp_rank, dev)
        cache = kvc.create_kv_cache(
            args.num_layers, case["pages"], args.kv_heads_local, case["page_size"],
            args.head_dim, args.quant.kv_bits,
            scale_dtype=kvc.scale_dtype_for(args.num_kv_heads), device=dev)
        t = [torch.from_numpy(np.asarray(x)) for x in case["prefill"]]
        pre, cache = llama.prefill(params, cache, *t, args)
        t = [torch.from_numpy(np.asarray(x)) for x in case["decode"]]
        dec, cache = llama.decode(params, cache, *t, args)
        out[case["name"]] = dict(prefill=_np(pre), decode=_np(dec))
    return out


def jobs_rank(rank: int, world_size: int, jobs: List[tuple]) -> list:
    """Several rank programs in one process, on one process group:
    [(fn, args)] -> [fn(rank, world_size, *args)]."""
    return [fn(rank, world_size, *args) for fn, args in jobs]


def benchmark_rank(rank: int, world_size: int, argv: List[str]) -> dict:
    """entrypoints/benchmark.py's main() on one rank, as torchrun runs it:
    `python -m qserve_tpu_torch.entrypoints.benchmark <argv>`. It leaves the
    process group at its end, so it is a rank's last program. Returns what
    the rank printed."""
    import contextlib
    import io
    import sys

    from qserve_tpu_torch.entrypoints import benchmark

    setup_rank(int(argv[argv.index("-tp") + 1]))
    out = io.StringIO()
    sys.argv = ["benchmark", *argv]
    with contextlib.redirect_stdout(out):
        benchmark.main()
    return dict(rank=rank, stdout=out.getvalue())


def reduce_check_rank(rank: int, world_size: int, n: int = 4096) -> dict:
    """One bf16 all_reduce through tp_all_reduce on the CPU: this rank's
    input (seeded by rank) and the sum it got, both as f32 numpy."""
    import types

    import torch

    from qserve_tpu_torch.parallel import tp as tpmod

    setup_rank(world_size)
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(n, generator=g).mul(2.0 ** torch.randint(-8, 8, (n,), generator=g))
    x = x.to(torch.bfloat16)
    y = tpmod.tp_all_reduce(x.clone(), types.SimpleNamespace(tp_size=world_size))
    return dict(x=_np(x), y=_np(y), dtype=str(y.dtype))


def _drive(engine, requests: List[dict], moe=None, cuda: bool = False) -> dict:
    """Step the engine until idle. Requests arrive in waves (`wave`, 0 if
    absent): a wave starts once the engine is idle and the wave before has
    arrived, and its request arrives `after` steps into it (or at once when
    the engine is idle). Returns the streams {id: [tokens of each output]}
    and one record a step: kind, host ms, CUDA-event ms, peak allocated
    GiB, kernel launches, collective calls and ms, and the MoE blocks'
    stream rows."""
    import torch

    from qserve_tpu_torch.kernels import _build
    from qserve_tpu_torch.parallel import tp as tpmod
    from qserve_tpu_torch.sampling_params import SamplingParams

    pending = sorted(requests, key=lambda r: (r.get("wave", 0), r.get("after", 0)))
    streams, log, steps, wave, start = {}, [], 0, None, 0
    while engine.has_unfinished_requests() or pending:
        if pending and pending[0].get("wave", 0) != wave and not engine.has_unfinished_requests():
            wave, start = pending[0].get("wave", 0), steps
        while pending and pending[0].get("wave", 0) == wave and (
                pending[0].get("after", 0) <= steps - start
                or not engine.has_unfinished_requests()):
            r = pending.pop(0)
            engine.add_request(r["id"], prompt_token_ids=list(r["prompt"]),
                               sampling_params=SamplingParams(**r["sp"]),
                               prefix_pos=r.get("prefix_pos"))
        before = dict(_build.LAUNCHES)
        tpmod.STATS.reset()
        if moe is not None:
            moe.rows.clear()
        if cuda:
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.reset_peak_memory_stats()
            ev0.record()
        t = time.perf_counter()
        outs = engine.step()
        if cuda:
            ev1.record()
            torch.cuda.synchronize()
        rec = dict(kind=engine.last_step_kind, ms=(time.perf_counter() - t) * 1e3,
                   launches={k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                             if v - before.get(k, 0)},
                   collectives=dict(tpmod.STATS.calls), collective_ms=dict(tpmod.STATS.ms))
        if cuda:
            rec.update(dev_ms=ev0.elapsed_time(ev1),
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if moe is not None:
            rec["rows"] = list(moe.rows)
        log.append(rec)
        steps += 1
        for out in outs:
            if out.finished:
                streams[out.request_id] = [list(o["token_ids"]) for o in out.outputs]
    return dict(streams=streams, log=log)


def keep_logits(runner, n: int) -> list:
    """Makes the runner's first n sampling calls also keep the logits of
    their live rows (f32 numpy) in the list returned."""
    kept = []
    sample = runner._sample

    def _sample(logits, sp_list, pad_to):
        if len(kept) < n:
            kept.append(logits[:len(sp_list)].float().cpu().numpy())
        return sample(logits, sp_list, pad_to)

    runner._sample = _sample
    return kept


def serve_rank(rank: int, world_size: int, spec: dict, moe=None) -> dict:
    """One rank of an engine at tp = world_size serving spec["requests"]
    (dicts: id, prompt, sp (SamplingParams fields), and optionally wave,
    after and prefix_pos: see _drive).
    The engine is EngineArgs(**spec["engine_args"]) on spec["device"], or,
    with spec["fp"], Worker.create_tp over those numpy float weights with
    spec["args"], spec["cache"] (CacheConfig fields) and spec["sched"]
    (SchedulerConfig fields). spec["time_collectives"] times them (the device
    synchronised around each); spec["keep_logits"] = n keeps the logits of
    the first n sampling calls (keep_logits). `moe`, an active recorder of
    the MoE blocks' stream rows (its `rows` list), labels each step's log.
    Returns the streams, the step log, the page count and the backend."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from qserve_tpu_torch.config import CacheConfig, SchedulerConfig
    from qserve_tpu_torch.engine.arg_utils import EngineArgs
    from qserve_tpu_torch.engine.llm_engine import LLMEngine
    from qserve_tpu_torch.kernels import _build
    from qserve_tpu_torch.parallel import tp as tpmod
    from qserve_tpu_torch.worker.worker import Worker

    device = spec.get("device", "cpu")
    tp_rank, _, dev = setup_rank(world_size, device=device)
    t0 = time.perf_counter()
    if "fp" in spec:
        args = dataclasses.replace(make_args(spec["args"]), tp_size=world_size)
        cc = CacheConfig(quant=args.quant, **spec["cache"])
        sc = SchedulerConfig(**spec["sched"])
        worker = Worker.create_tp(_float_params(spec["fp"]), args, cc, sc,
                                  tp_size=world_size, seed=spec.get("seed", 0), device=dev)
        engine = LLMEngine(worker, sc, cc)
    else:
        engine = EngineArgs(device=device, tensor_parallel_size=world_size,
                            **spec["engine_args"]).build_engine()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    tpmod.STATS.timed = bool(spec.get("time_collectives"))
    _build.reset_launch_counts()
    kept = keep_logits(engine.worker.model_runner, spec.get("keep_logits", 0))
    run = _drive(engine, spec["requests"], moe, cuda)
    cache = engine.worker.cache_engine.cache
    return dict(run, logits=kept, tp_rank=tp_rank, build_s=build_s, launches=dict(_build.LAUNCHES),
                num_pages=engine.cache_config.num_device_pages,
                cache_shape=(tuple(cache.data.shape), tuple(cache.scales.shape),
                             str(cache.scales.dtype)),
                backend=dist.get_backend(), device=str(dev),
                allocated_gib=(torch.cuda.memory_allocated(dev) / 2**30) if cuda else None)


def robustness_rank(rank: int, world_size: int, spec: dict) -> dict:
    """tests/test_tp_engine.py's robustness cases on one rank of a tp =
    world_size engine over spec's float weights (`fp`, `args`): abort,
    recompute and swap preemption, chunked against unchunked, decodes riding
    with chunk steps, n = 2 greedy (whole and chunked prompts). Returns what
    each case's checks read."""
    import dataclasses

    from qserve_tpu_torch.config import CacheConfig, SchedulerConfig
    from qserve_tpu_torch.core.scheduler import PreemptionMode
    from qserve_tpu_torch.engine.llm_engine import LLMEngine
    from qserve_tpu_torch.sampling_params import SamplingParams
    from qserve_tpu_torch.worker.worker import Worker

    _, _, dev = setup_rank(world_size)
    args = dataclasses.replace(make_args(spec["args"]), tp_size=world_size)
    fp = _float_params(spec["fp"])

    def engine(num_pages=32, max_seqs=4, num_cpu_pages=0, max_len=96, max_tokens=256):
        cc = CacheConfig(block_size=16, num_device_pages=num_pages,
                         num_cpu_pages=num_cpu_pages, quant=args.quant)
        sc = SchedulerConfig(max_num_batched_tokens=max_tokens, max_num_seqs=max_seqs,
                             max_model_len=max_len)
        return LLMEngine(Worker.create_tp(fp, args, cc, sc, tp_size=world_size,
                                          device=dev), sc, cc)

    def drive(e, max_steps=400):
        outs, steps = [], 0
        while e.has_unfinished_requests() and steps < max_steps:
            outs.extend(e.step())
            steps += 1
        return {o.request_id: [list(c["token_ids"]) for c in o.outputs]
                for o in outs if o.finished}

    def greedy(n):
        return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True)

    def free(e):
        return e.scheduler.block_manager.get_num_free_device_pages()

    res = {}
    e = engine()
    e.add_request("a", prompt_token_ids=[1, 2, 3], sampling_params=greedy(20))
    e.add_request("b", prompt_token_ids=[4, 5, 6], sampling_params=greedy(20))
    e.step()
    e.abort_request("a")
    res["abort"] = dict(done=sorted(drive(e)), free=free(e))

    e = engine(num_pages=7, max_seqs=3)
    for i in range(3):
        e.add_request(f"r{i}", prompt_token_ids=[i + 1] * 14, sampling_params=greedy(34))
    done = drive(e)
    res["recompute"] = dict(lens={k: len(v[0]) for k, v in done.items()}, free=free(e),
                            streams=done)

    e = engine(num_pages=8, num_cpu_pages=8)
    e.add_request("s0", prompt_token_ids=[1] * 14, sampling_params=greedy(8))
    e.step()
    group = e.scheduler.running[0]
    swaps: dict = {}
    e.scheduler._preempt(group, swaps, mode=PreemptionMode.SWAP)
    e.scheduler.running.clear()
    swapped = group in e.scheduler.swapped and bool(swaps)
    e.worker.cache_engine.swap_out(swaps)
    done = drive(e)
    res["swap"] = dict(swapped=swapped, lens={k: len(v[0]) for k, v in done.items()},
                       streams=done)

    prompt = [(7 * i + 3) % args.vocab_size for i in range(72)]
    whole, chunked = engine(max_tokens=256), engine(max_tokens=32)
    for x in (whole, chunked):
        x.add_request("r", prompt_token_ids=prompt, sampling_params=greedy(6))
    res["chunked"] = dict(whole=drive(whole)["r"], chunked=drive(chunked)["r"],
                          free=free(chunked))

    e = engine(max_tokens=32)
    e.add_request("run", prompt_token_ids=[3, 1, 4], sampling_params=greedy(16))
    e.step()
    run_seq = e._seq_index[0][1]
    e.add_request("long", prompt_token_ids=[(i * 5 + 1) % args.vocab_size for i in range(72)],
                  sampling_params=greedy(4))
    stalled, chunk_steps, outs, steps = 0, 0, [], 0
    while e.has_unfinished_requests() and steps < 60:
        before, was_done = run_seq.get_output_len(), run_seq.is_finished()
        outs.extend(e.step())
        steps += 1
        if not was_done and e.scheduler.waiting:
            chunk_steps += 1
            stalled += run_seq.get_output_len() != before + 1
    res["ride_along"] = dict(chunk_steps=chunk_steps, stalled=stalled, free=free(e),
                             lens={o.request_id: len(o.outputs[0]["token_ids"])
                                   for o in outs if o.finished})

    for name, p, max_tokens in (("n2", [7, 8, 9], 256),
                                ("n2_chunked", [(11 * i + 2) % args.vocab_size
                                                for i in range(72)], 32)):
        solo, dual = engine(max_tokens=max_tokens), engine(max_tokens=max_tokens)
        solo.add_request("s", prompt_token_ids=p, sampling_params=greedy(5))
        dual.add_request("d", prompt_token_ids=p, sampling_params=SamplingParams(
            n=2, max_tokens=5, temperature=0.0, ignore_eos=True))
        res[name] = dict(want=drive(solo)["s"][0], got=drive(dual)["d"], free=free(dual))
    return res
