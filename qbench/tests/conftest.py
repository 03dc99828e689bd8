"""Tests of the benchmark harness. Most run on the CPU through the port's
plain paths at tiny widths; those marked `card` need a CUDA device and skip
without one (decided in the `card` fixture, not at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the H100)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


REAL = {(False, "decode-batch"): "mistral-7b.decode-batch",
        (True, "decode-batch"): "mixtral-8x7b.decode-batch",
        (False, "chat-bursty"): "mistral-7b.decode-batch",
        (True, "doc-batch"): "mixtral-8x7b.doc-batch"}


def tiny_cell(moe=False, traffic="decode-batch", limits=(1.0, 1.0)):
    """The real cell, cut to tiny widths on the CPU: 2 layers, hidden 64,
    4 heads over 2 kv heads, 512 ids, pages of 16, a 64-token budget, 16
    sequences, 4 requests checked; its metrics and settings otherwise its
    own."""
    from qbench import registry

    cell = registry.load_cell(REAL[(moe, traffic)])  # read anew: its dicts are its own
    if cell.traffic_name != traffic:
        # the chat mix has no cell while the scheduler's max_num_seqs fault
        # stands (PERF.md): its files wait, run here with its latency metrics
        cell.traffic_name = traffic
        cell.traffic = registry.load_traffic(traffic)
        cell.end_to_end = cell.end_to_end + [
            {"name": n, "unit": "ms", "better": "lower", "bound": 0.1, "source": "host_clock"}
            for n in ("ttft_p95_ms", "tpot_p95_ms")]
    cfg, tr = cell.config, cell.traffic
    cfg.update(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2)
    if moe:
        cfg.update(num_local_experts=4)
    else:
        cfg.update(sliding_window=48)  # inside the tiny lengths: the window is exercised
    cfg["serving"].update(page_size=16, max_num_batched_tokens=64, max_num_seqs=16,
                          max_model_len=256)
    if tr["loop"] == "closed":
        tr.update(clients=4, warmup_steps=5, deck_size=64)
    else:
        tr.update(rate_per_s=8.0, warmup_s=0.5)
    tr["prompt_len"].update(median=24, min=8, max=90)
    tr["output_len"].update(median=10, min=4, max=30)
    tr["check"].update(requests=4, scored_tokens=30)
    # the stds scaled to the widths (64 against 4096: x 8), so that a
    # layer's share of the residual stream is what it is at full size
    std = cfg["assumed"]["weight_std"]
    std.update({k: 8 * v for k, v in std.items()})
    cell.name = "tiny." + cell.name
    cell.limits = {"logit_gap": {"limit": limits[0]}, "mean_gap": {"limit": limits[1]}}
    return cell


# Faults planted under the timed path (monkeypatch), for the tests that see
# a broken run come out not correct.

def alter_tokens(monkeypatch):
    """Every other row of each step gets the next id instead of its own."""
    from qserve_tpu_torch.layers import sampler

    orig = sampler.sample

    def sample(logits, *a, **k):
        ids = orig(logits, *a, **k).clone()
        ids[::2] = (ids[::2] + 1) % logits.shape[-1]
        return ids

    monkeypatch.setattr(sampler, "sample", sample)


def skip_kv_append(monkeypatch):
    from qserve_tpu_torch.kernels import kv_cache

    monkeypatch.setattr(kv_cache, "append_all_layers", lambda cache, *a, **k: cache)


def drop_half_the_batch(monkeypatch):
    """A decode step's logits zeroed from row B // 2 on."""
    from qserve_tpu_torch.models import llama

    orig = llama.decode

    def decode(*a, **k):
        logits, kv = orig(*a, **k)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0.0
        return logits, kv

    monkeypatch.setattr(llama, "decode", decode)
