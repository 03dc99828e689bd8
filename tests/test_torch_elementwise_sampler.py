"""Host-side shapes and arithmetic of K1 (csrc/elementwise.cu) and K7
(csrc/sampler.cu), held on the CPU before any card runs them.

K1: `elementwise.launch_shape(W)` gives the block of one row; every column
of the row must belong to exactly one (chunk, slot, thread) of the kernel's
map, within the block limits the kernel was compiled for.

K7: `sampler.cluster_split(V)` gives the CTAs of a row's cluster and the
columns each holds in shared memory. A numpy transcription of the kernel's
cluster-combined searches (4 thresholds a pass; per-thread sums in column
order, xor trees over a warp's lanes and over the warps, CTAs in rank
order, all in f32) must keep exactly the
sets of the port's threshold_mask and the JAX package's, and draw the JAX
package's Pallas sampler's token (interpret mode) under the same noise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.kernels import pallas_sampler as jps
from qserve_tpu.layers import sampler as jsampler
from qserve_tpu_torch.kernels import elementwise, sampler as ksampler
from qserve_tpu_torch.layers import sampler as tsampler
import torch_port_util  # noqa: F401  (one torch thread a test process)

# full-size widths (Llama-3-8B, Llama-2-7B, Qwen2-0.5B), the CPU tests' and
# chip_smoke.py's small models', 2 short of a multiple of 8, and rows of 1
# column and of two or three chunks
WIDTHS = [4096, 11008, 14336, 896, 4864, 64, 96, 128, 256, 512, 4094, 1, 40000, 70000]


@pytest.mark.parametrize("few", [False, True], ids=["many_rows", "few_rows"])
@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("W", WIDTHS)
def test_k1_launch_shape_covers_the_row_once(W, f32, few):
    s = elementwise.launch_shape(W, f32, few)
    assert 32 <= s.threads <= elementwise.MAX_THREADS and s.threads % 32 == 0
    top = elementwise.MAX_VPT_F32 if f32 else elementwise.MAX_VPT
    assert 1 <= s.vpt <= top and s.chunks >= 1
    nv = -(-W // elementwise.VEC)
    # the kernel's map: vector j = (c * vpt + v) * threads + t, live if j < nv
    c, v, t = np.meshgrid(np.arange(s.chunks), np.arange(s.vpt), np.arange(s.threads),
                          indexing="ij")
    j = ((c * s.vpt + v) * s.threads + t).ravel()
    j = j[j < nv]
    cols = (j[:, None] * elementwise.VEC + np.arange(elementwise.VEC)).ravel()
    cols = cols[cols < W]
    np.testing.assert_array_equal(np.bincount(cols, minlength=W), np.ones(W))
    assert s.tail == W - elementwise.VEC * (nv - 1)
    # no power-of-two pad: idle vector slots stay under one slot a thread
    # (a 32-thread block may idle more on a row narrower than 32 vectors)
    idle = s.chunks * s.threads * s.vpt - nv
    assert idle < max(s.threads, 32 * s.vpt) * s.chunks
    if W in (4096, 14336):  # the Llama-3-8B rows fill their blocks exactly
        assert idle == 0


@pytest.mark.parametrize("V", [128256, 32000, 151936, 12800, 4224, 4097, 384, 1])
def test_k7_cluster_split_covers_the_row_once(V):
    s = ksampler.cluster_split(V)
    assert 1 <= s.cluster <= 8 and s.slice % 4 == 0
    assert s.slice * 4 <= 227 * 1024
    starts = np.arange(s.cluster) * s.slice
    cover = np.zeros(V, np.int64)
    for r0 in starts:
        cover[r0:min(V, r0 + s.slice)] += 1
    np.testing.assert_array_equal(cover, np.ones(V))
    assert s.cluster == 8 or V <= ksampler.COLUMNS_PER_CTA * s.cluster
    assert s.threads == (512 if s.slice > 8192 else 256)


def test_k7_cluster_split_refuses_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        ksampler.cluster_split(8 * ksampler.MAX_SLICE + 4)


PROBES = 4  # csrc/sampler.cu's
TOP = 0x80000000


def _keys(x):
    b = x.view(np.int32).astype(np.int64)
    return np.where(b >= 0, b, b ^ 0x7FFFFFFF)


def _to_u(s):
    return (int(s) & 0xFFFFFFFF) ^ TOP


def _to_s(u):
    v = u ^ TOP
    return v - (1 << 32) if v >= 1 << 31 else v


def _xor_tree(w):
    """A warp's lanes (the last axis, 32) combined by xor shuffles."""
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., np.arange(32) ^ o]
    return w[..., 0]


def _cluster_sum(a, split):
    """csrc/sampler.cu Cluster::reduce of a sum: each thread adds its
    columns i = t, t + threads, ... of its CTA's slice in order, a warp's
    lanes combine by xor tree, warp 0 combines the warps' partials by xor
    tree (0 past them), and every CTA adds the CTAs' partials in rank
    order."""
    THREADS = split.threads
    WARPS = THREADS // 32
    total = None
    for r in range(split.cluster):
        sl = a[r * split.slice:(r + 1) * split.slice]
        it = max(1, -(-len(sl) // THREADS))
        pad = np.zeros(it * THREADS, a.dtype)
        pad[:len(sl)] = sl
        acc = np.zeros(THREADS, a.dtype)
        for i in range(it):
            acc = acc + pad[i * THREADS:(i + 1) * THREADS]
        lanes = np.zeros(32, a.dtype)
        lanes[:WARPS] = _xor_tree(acc.reshape(WARPS, 32))
        s = _xor_tree(lanes)
        total = s if total is None else total + s
    return total


def _search(lo, hi, f_ge):
    """The kernel's search: PROBES thresholds a pass, evenly through
    (lo, hi); the largest passing one becomes lo, the smallest failing one
    hi, until hi - lo <= 1."""
    lo, hi = _to_u(lo), _to_u(hi)
    for _ in range(32):
        if hi - lo <= 1:
            break
        m = [lo + (hi - lo) * (j + 1) // (PROBES + 1) for j in range(PROBES)]
        ok = [f_ge(_to_s(mj)) for mj in m]
        lo, hi = (max([lo] + [mj for mj, o in zip(m, ok) if o]),
                  min([hi] + [mj for mj, o in zip(m, ok) if not o]))
    return _to_s(lo)


def _k7_row(x, k, p, noise, split):
    """One row through the kernel's arithmetic: (kept mask, token)."""
    V = len(x)
    keys = _keys(x)
    rowmax_k, rowmin_k = int(keys.max()), int(keys.min())
    thr = rowmin_k - 1
    if k < V:
        thr = _search(rowmin_k - 1, rowmax_k, lambda t: _cluster_sum(
            (keys > t).astype(np.int32), split) >= k)
    if p < 1.0:
        rowmax = x[int(np.argmax(keys))]
        kept = keys > thr
        se = _cluster_sum(np.where(kept, np.exp(x - rowmax), np.float32(0)), split)
        lse = np.float32(rowmax + np.log(se))
        kept_min = int(keys[kept].min())
        thr = max(thr, _search(kept_min - 1, rowmax_k, lambda t: _cluster_sum(
            np.where(keys > t, np.exp(x - lse), np.float32(0)), split) >= np.float32(p)))
    kept = keys > thr
    return kept, int(np.argmax(np.where(kept, x + noise, -np.inf)))


# each row's (top_k, top_p): ties at the 5th value, top-p alone, both,
# top-k 1, top-p near 1 over a top-k set of 4 tied values (the top-p
# interval is one key wide: no probe, the start keeps all), no filter,
# top-k alone, a small top-p
ROWS = [(5, 1.0), (0, 0.9), (50, 0.9), (1, 1.0), (4, 1 - 2.0**-24), (0, 1.0), (7, 1.0),
        (0, 0.3)]
# a row with no filter: the kernel skips both bisections and keeps all; the
# references still bisect it at target 1, where an f32 mass of 1 or more
# may drop its lowest-mass tokens (ROADMAP.md's standing divergences)
UNFILTERED = 5


# clusters of 2, 4, 1 and 8 CTAs (the last of 512 threads)
@pytest.mark.parametrize("V,seed", [(4224, 0), (4224, 1), (12800, 2), (384, 3), (66048, 4)])
def test_k7_cluster_arithmetic_matches_the_references(V, seed):
    rng = np.random.default_rng(seed)
    B = len(ROWS)
    x = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    order = np.argsort(-x[0])
    x[0, order[5:8]] = x[0, order[4]]  # ranks 5..8 tie with the 5th: 8 kept
    x[4, np.argsort(-x[4])[:4]] = x[4].max()  # the top 4 tie
    noise = -np.log(-np.log(rng.random((B, V)).astype(np.float32).clip(2.0**-24, None)))
    tk = np.array([k for k, _ in ROWS], np.int32)
    tp = np.array([p for _, p in ROWS], np.float32)
    k_eff = np.where(tk <= 0, V, tk)
    split = ksampler.cluster_split(V)
    assert split.cluster == min(8, -(-V // 4096))

    got = [_k7_row(x[r], int(k_eff[r]), float(tp[r]), noise[r], split) for r in range(B)]
    kept = np.stack([g[0] for g in got])
    toks = np.array([g[1] for g in got])
    assert kept[0].sum() == 8 and kept[3].sum() == 1 and kept[4].sum() == 4
    assert kept[UNFILTERED].all()
    filt = np.arange(B) != UNFILTERED
    want_t = tsampler.threshold_mask(torch.from_numpy(x), torch.from_numpy(tp),
                                     torch.from_numpy(tk)).numpy() > -1e29
    want_j = np.asarray(jsampler.threshold_mask(jnp.asarray(x), jnp.asarray(tp),
                                                jnp.asarray(tk))) > -1e29
    np.testing.assert_array_equal(kept[filt], want_t[filt])
    np.testing.assert_array_equal(kept[filt], want_j[filt])
    pallas = jps._sample_call(
        jnp.asarray(x), jnp.asarray(k_eff.astype(np.float32))[:, None],
        jnp.asarray(np.maximum(tp, 1e-9))[:, None], jnp.zeros(2, jnp.int32),
        jnp.asarray(noise), True, True)
    np.testing.assert_array_equal(toks[filt], np.asarray(pallas)[filt])
