"""Split-K of the quantized GEMMs (kernels/gemm.py `split_k`, `k_slices`;
csrc/gemm_common.cuh): the plan at the benchmark configurations' shapes on
an H100's 132 SMs, the slices' cover of K, and a plain transcription of the
kernel's split (int32 partial sums of each slice's steps, added, then the
unchanged epilogue) against the plain per-channel GEMM, bit for bit."""

import numpy as np
import pytest
import torch

from qserve_tpu_torch.kernels import gemm, ops
import torch_port_util  # noqa: F401  (one torch thread a test process)

SMS = 132  # an H100 SXM

# (K, N) of each linear at the configurations' published widths: Mistral-7B
# and Mixtral-8x7B (hidden 4096, 32 heads over 8 kv heads of 128, FFN 14336,
# Mixtral's per expert), Mellum2-12B-A2.5B (hidden 2304, 32 heads over 4 kv
# heads of 128, expert FFN 896)
LINEARS = {
    "mistral": dict(qkv=(4096, 6144), o=(4096, 4096), gate_up=(4096, 28672),
                    down=(14336, 4096)),
    "mellum": dict(qkv=(2304, 5120), o=(4096, 2304), gate_up=(2304, 1792),
                   down=(896, 2304)),
}
# routed K10 streams: a 2048-token chunk's top-k rows padded into 256-row
# blocks (Mixtral top-2 of 8, Mellum top-8 of 64), and the least a doc-batch
# chunk gives
ROUTED_ROWS = {"mistral": (4096, 6144), "mellum": (16384, 32768)}

UNSPLIT = [(m, M, n) for m in LINEARS for M in (2048,) for n in LINEARS[m]]
UNSPLIT += [(m, M, n) for m in LINEARS for M in ROUTED_ROWS[m] for n in ("gate_up", "down")]
# decode: Mistral's and Mixtral's qkv, o and down at 16 and 128 rows split;
# their gate_up (224 tiles) fills the SMs. Mellum's qkv, o and gate_up at
# its 32 rows split; its down is 14 steps, shorter than two slices of
# MIN_STEPS (measured unsplit fastest)
SPLIT = [("mistral", M, n) for M in (16, 128) for n in ("qkv", "o", "down")]
SPLIT += [("mellum", 32, n) for n in ("qkv", "o", "gate_up")]
DECODE_UNSPLIT = [("mistral", M, "gate_up") for M in (16, 128)] + [("mellum", 32, "down")]


@pytest.mark.parametrize("model,M,name", UNSPLIT + SPLIT + DECODE_UNSPLIT)
def test_plan_at_the_cells_shapes(model, M, name):
    K, N = LINEARS[model][name]
    s = gemm.split_k(M, N, K, SMS)
    tiles = -(-M // gemm.TILE) * -(-N // gemm.TILE)
    if (model, M, name) in SPLIT:
        assert s > 1
        assert tiles * s <= SMS  # one block an SM: the workspace holds it
        assert K // gemm.STEP // s >= gemm.MIN_STEPS
    else:
        assert s == 1


@pytest.mark.parametrize("tiles,steps,want", [
    (132, 64, 1),  # the grid fills the SMs
    (1000, 224, 1),
    (33, 64, 4),  # 132 // 33
    (32, 64, 4),
    (1, 64, 8),  # capped by MIN_STEPS: 64 // 8
    (1, 15, 1),  # one slice of 15 steps: fewer than two of MIN_STEPS
    (1, 16, 2),
])
def test_plan_rule(tiles, steps, want):
    """One block an SM, slices of at least MIN_STEPS steps: the same rule for
    every shape, read from (M, N, K) and the SM count alone."""
    assert gemm.MIN_STEPS == 8
    assert gemm.split_k(gemm.TILE, tiles * gemm.TILE, steps * gemm.STEP, SMS) == want


PLANS = sorted({(K, gemm.split_k(M, N, K, SMS)) for m, M, n in SPLIT + UNSPLIT
                for K, N in [LINEARS[m][n]]} | {(896, 3), (896, 14), (4096, 7)})


@pytest.mark.parametrize("K,s", PLANS)
def test_slices_cover_k_once(K, s):
    """Slices are whole 64-k steps, in order, covering K's steps once; in
    K2's and K8's half-split packing step t holds k in [32 t, 32 t + 32) and
    [K/2 + 32 t, K/2 + 32 t + 32), so the slices cover every k once."""
    sl = gemm.k_slices(K, s)
    assert len(sl) == s and sl[0][0] == 0 and sl[-1][1] == K // gemm.STEP
    assert all(a < b for a, b in sl)  # no empty slice at these plans
    assert all(sl[i][1] == sl[i + 1][0] for i in range(s - 1))
    sizes = [b - a for a, b in sl]
    assert max(sizes) - min(sizes) <= 1  # even to a step
    seen = np.zeros(K, np.int32)
    for a, b in sl:
        for half in (0, K // 2):
            seen[half + 32 * a:half + 32 * b] += 1
    assert (seen == 1).all()


def _split_gemm(a_i8, a_scale, a_sum, packed, s1, sz, s):
    """The kernel's split in plain PyTorch: slice z's int32 partial sums over
    its steps' k (both nibble planes), the slices' partials added in int32,
    then the epilogue in its f32 order, rounded once to bf16."""
    K = a_i8.shape[1]
    w = torch.cat([packed.to(torch.int32) & 0xF, (packed.to(torch.int32) >> 4) & 0xF])
    psum = torch.zeros(a_i8.shape[0], packed.shape[1], dtype=torch.int32)
    for s0, s1_ in gemm.k_slices(K, s):
        ks = torch.cat([torch.arange(32 * s0, 32 * s1_),
                        torch.arange(K // 2 + 32 * s0, K // 2 + 32 * s1_)])
        part = a_i8[:, ks].to(torch.int64) @ w[ks].to(torch.int64)
        psum += part.to(torch.int32)
    out = psum.to(torch.float32) * s1[None, :] * a_scale - sz[None, :] * a_sum
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("M", [1, 17, 128])
@pytest.mark.parametrize("model,name", sorted({(m, n) for m, _, n in SPLIT}))
def test_split_sum_is_the_plain_gemm(model, name, M, seed):
    """At each decode plan (K and its split; 128 of the N columns: columns
    are independent), the sum of the slices' partial products through the
    epilogue equals w4a8_gemm_per_chn_plain bit for bit."""
    K, N = LINEARS[model][name]
    s = gemm.split_k(M, N, K, SMS)
    assert s > 1
    r = np.random.default_rng(seed)
    n = 128
    a = torch.from_numpy(r.integers(-128, 128, (M, K)).astype(np.int8))
    packed = torch.from_numpy(r.integers(-128, 128, (K // 2, n)).astype(np.int8))
    asc = torch.from_numpy(r.random((M, 1), np.float32) * 0.05)
    asum = torch.from_numpy(r.standard_normal((M, 1)).astype(np.float32))
    s1 = torch.from_numpy(r.random(n, np.float32) * 1e-3)
    sz = torch.from_numpy(r.random(n, np.float32) * 8e-3)
    want = ops.w4a8_gemm_per_chn_plain(a, asc, asum, packed, s1, sz)
    got = _split_gemm(a, asc, asum, packed, s1, sz, s)
    assert torch.equal(got, want)
