"""Port parity: on one scripted add/step trace, the port's scheduler (a
copy of qserve_tpu.core) makes the same decisions as the JAX package's:
admissions, chunking, page tables, refusals and preemption."""

import pytest

import qserve_tpu.config as jconfig
import qserve_tpu.core.scheduler as jsched
import qserve_tpu.sampling_params as jsp
import qserve_tpu.sequence as jseq
import qserve_tpu_torch.config as tconfig
import qserve_tpu_torch.core.scheduler as tsched
import qserve_tpu_torch.sampling_params as tsp
import qserve_tpu_torch.sequence as tseq

BS = 16


def _trace(config, sched_mod, sp_mod, seq_mod, chunked, pages):
    """Drive one scheduler through a fixed script; return its decisions."""
    sc = config.SchedulerConfig(
        max_num_batched_tokens=64, max_num_seqs=4, max_model_len=256,
        enable_chunked_prefill=chunked,
    )
    cc = config.CacheConfig(block_size=BS, num_device_pages=pages,
                            quant=config.QuantSpec.from_precision("w4a8kv4"))
    s = sched_mod.Scheduler(sc, cc)
    seqs = {}
    script = {0: [("a", 20), ("b", 45), ("c", 90)], 2: [("d", 30)],
              5: [("e", 300)], 7: [("f", 12)], 9: [("g", 40)]}
    log = []
    for step in range(40):
        for rid, n in script.get(step, []):
            seq = seq_mod.Sequence(len(seqs), "p", list(range(1, n + 1)), BS)
            seqs[seq.seq_id] = seq
            s.add_seq_group(seq_mod.SequenceGroup(
                rid, [seq], sp_mod.SamplingParams(max_tokens=12)))
        md, out = s.schedule()
        log.append((
            out.prompt_run, out.num_batched_tokens,
            sorted(g.request_id for g in out.ignored_seq_groups),
            dict(out.blocks_to_copy), dict(out.blocks_to_swap_in),
            dict(out.blocks_to_swap_out), dict(out.prompt_chunks),
            [(m.request_id, m.is_prompt, m.chunk, sorted(m.block_tables.items()))
             for m in md],
        ))
        # advance as an engine would: every scheduled running seq emits a token
        for m in md:
            for sid, data in m.seq_data.items():
                seq = seqs[sid]
                if seq.status != seq_mod.SequenceStatus.RUNNING:
                    continue
                seq.append_token_id(7)
                if seq.get_output_len() >= 12:
                    seq.status = seq_mod.SequenceStatus.FINISHED_LENGTH_CAPPED
                    s.free_seq(seq)
        s.free_finished_seq_groups()
        if not s.has_unfinished_seqs() and step > max(script):
            break
    return log


# 10 pages force recompute preemptions; 64 pages admit without pressure
@pytest.mark.parametrize("chunked,pages", [(False, 10), (True, 10), (False, 64)])
def test_same_decisions_on_scripted_trace(chunked, pages):
    want = _trace(jconfig, jsched, jsp, jseq, chunked, pages)
    got = _trace(tconfig, tsched, tsp, tseq, chunked, pages)
    assert len(want) > 10
    assert got == want
