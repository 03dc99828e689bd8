"""K5 (csrc/kv_append.cu, the fused KV quantize-and-append) held on the CPU
before any card runs it.

A numpy transcription of the kernel's per-vector arithmetic, in its lane
layout (8 values a lane from one 16-byte load, a (max, -min) pair a lane
max-reduced by an xor tree over a group of G lanes, or on the scalar path
dims lane + 32 i and f32 min/max over a warp; IEEE
f32 divisions, (x - lo) / scale as a product with the reciprocal and the
IEEE quotient near half-way points, rint half to even, the KV4 high nibble from the lane D/16
on, scale and zero rounded to bf16 by RNE) and its block structure (tb
tokens a block, the scale rows staged [kv][2H][token] and written by
consecutive threads over consecutive tokens) must leave a cache equal byte
for byte (tolerance: none) to the JAX package's `append_all_layers` (its
XLA quantize and scatter, what it runs on the CPU) and to the port's plain
chain (`kv_cache.append_plain`, what `append_all_layers` runs on the CPU),
from the same non-zero starting cache. Cases: KV4 and KV8, zero point on
and off, bf16 scales (H = 8) and f32 (H = 2), D = 64 and 128, padding
tokens (page -1) inside and after the batch, a constant vector (the 1e-8
clamp), vectors whose quotients land on half-way points of the lattice, a
value whose product with the reciprocal rounds apart from its quotient, a
scale on a half-way point of bf16 (RNE rounds it down), and k/v given as the mixed step's strided k_all[:, :T] view."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.kernels import kv_cache as jkvc
from qserve_tpu_torch.kernels import kv_append, kv_cache as tkvc
from torch_port_util import to_np

L, P, PS = 3, 7, 16


def _bf16_rne(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits, round to nearest even (finite values)."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def _xor_tree(a, G, op):
    """Every lane of a group of G ends with op over the group, as the
    kernel's __shfl_xor_sync tree leaves it."""
    lane = np.arange(G)
    off = G // 2
    while off:
        a = op(a, a[..., lane ^ off])
        off //= 2
    return a


def _quantize_lanes(x, bits, zero_point, lanes):
    """x f32 [N, D] (bf16 values) -> (bytes uint8 [N, Dc], scale f32 [N],
    zero f32 [N]) as the kernel computes them: lanes = G of the vector
    path, 0 for the scalar path."""
    N, D = x.shape
    f32 = np.float32
    if lanes:  # lane li holds dims 8 li .. 8 li + 7; lanes past D / 8 none
        G = lanes
        xl = np.zeros((N, G, 8), f32)
        xl[:, :D // 8] = x.reshape(N, D // 8, 8)
        live = np.broadcast_to((np.arange(G) < D // 8)[:, None], (G, 8))
    else:  # a warp: lane holds dims lane + 32 i
        G = 32
        xp = np.zeros((N, 256), f32)
        xp[:, :D] = x
        xl = xp.reshape(N, 8, 32).transpose(0, 2, 1)
        live = (np.arange(32)[:, None] + 32 * np.arange(8)[None, :]) < D
    if zero_point and lanes:  # a bf16 pair (max, -min) a lane, max-reduced
        pair = np.stack([np.where(live, xl, -np.inf).max(-1),
                         np.where(live, -xl, -np.inf).max(-1)], -1)
        pair = _xor_tree(pair.transpose(0, 2, 1), G, np.maximum)[:, :, 0]
        mx, mn = pair[:, 0], -pair[:, 1]
    elif zero_point:  # the scalar path: f32 max and min over a warp
        mx = _xor_tree(np.where(live, xl, -np.inf).max(-1), G, np.maximum)[:, 0]
        mn = _xor_tree(np.where(live, xl, np.inf).min(-1), G, np.minimum)[:, 0]
    if zero_point:
        qmax = (1 << bits) - 1
        scale = np.maximum(mx - mn, f32(1e-8)) / f32(qmax)
        zero, base, qlo, qhi, offset = mn, mn, 0, qmax, 0
    else:
        amax = _xor_tree(np.where(live, np.abs(xl), 0).max(-1), G, np.maximum)[:, 0]
        half = ((1 << bits) - 1) // 2
        scale = np.maximum(amax, f32(1e-8)) / f32(half)
        zero = f32(-(1 << (bits - 1))) * scale
        base, qlo, qhi, offset = np.zeros_like(scale), -half - 1, half, 1 << (bits - 1)
    assert scale.dtype == zero.dtype == np.float32
    # (x - lo) / scale as a product with the IEEE reciprocal; the IEEE
    # quotient where the product is within 1e-4 of a half-way point
    d = xl - base[:, None, None]
    p = d * (f32(1) / scale)[:, None, None]
    r = np.rint(p)
    r = np.where(np.abs(p - r) > f32(0.4999), np.rint(d / scale[:, None, None]), r)
    codes = (np.clip(r, qlo, qhi) + offset).astype(np.uint32)  # [N, lane, value]
    if lanes:
        if bits == 4:  # the low lanes pack their partner's codes as high nibbles
            out = codes[:, :D // 16] | (codes[:, D // 16:D // 8] << 4)
        else:
            out = codes[:, :D // 8] ^ 0x80
        return out.reshape(N, -1).astype(np.uint8), scale, zero
    flat = codes.transpose(0, 2, 1).reshape(N, 256)[:, :D]  # codes by dim
    out = flat[:, :D // 2] | (flat[:, D // 2:] << 4) if bits == 4 else flat ^ 0x80
    return out.astype(np.uint8), scale, zero


def _kernel_append(data, scales, k, v, pages, slots, bits, zero_point, shape):
    """The kernel on numpy arrays: data uint8 [L, P, 2, ps, H*Dc], scales
    as bf16 (uint16) or f32 (uint32) bits [L, P, 2, 2H, ps], k/v f32
    [L, T, H, D]."""
    Lk, T, H, D = k.shape
    ps, H2, tb = data.shape[3], 2 * H, shape.tb
    x = np.stack([k, v], axis=2).reshape(-1, D)  # vectors (l, t, kv, h)
    rows, sc, zr = _quantize_lanes(x, bits, zero_point, shape.lanes)
    rows = rows.reshape(Lk, T, 2, -1)
    sc, zr = sc.reshape(Lk, T, 2, H), zr.reshape(Lk, T, 2, H)
    bits_of = _bf16_rne if scales.dtype == np.uint16 else (lambda s: s.view(np.uint32))
    for l in range(Lk):
        for t0 in range(0, T, tb):
            n = min(tb, T - t0)
            pg = np.full(tb, -1)
            pg[:n] = pages[t0:t0 + n]
            sl = np.zeros(tb, np.int64)
            sl[:n] = slots[t0:t0 + n]
            for tok in range(n):
                if pg[tok] >= 0:
                    data[l, pg[tok], :, sl[tok]] = rows[l, t0 + tok]
            staged = np.zeros((2, H2, tb), scales.dtype)  # [kv][2H][token]
            staged[:, :H, :n] = bits_of(sc[l, t0:t0 + n]).transpose(1, 2, 0)
            staged[:, H:, :n] = bits_of(zr[l, t0:t0 + n]).transpose(1, 2, 0)
            i = np.arange(2 * H2 * tb)  # the write loop's thread index
            tok, row = i % tb, i // tb
            keep = pg[tok] >= 0
            scales[l, pg[tok][keep], row[keep] // H2, row[keep] % H2,
                   sl[tok][keep]] = staged.reshape(-1)[keep]


def _inputs(H, D, bits, zero_point, seed):
    """k_all, v_all bf16 [L, T + 3, H, D] (the first T rows are appended,
    as the mixed step's k_all[:, :T]) and the batch's pages and slots: a
    prompt over pages 0-1 from slot 0, a padding row inside the batch, a
    prompt continuing at slot 5 of page 4, two decode tokens on their own
    pages, two trailing padding rows."""
    r = np.random.default_rng(seed)
    pages = [0] * PS + [1] * 4 + [-1] + [4] * 6 + [2, 6, -1, -1]
    slots = list(range(PS)) + list(range(4)) + [0] + list(range(5, 11)) + [9, 3, 0, 0]
    T = len(pages)
    k = r.standard_normal((L, T + 3, H, D)).astype(np.float32)
    v = (3 * r.standard_normal((L, T + 3, H, D))).astype(np.float32)
    k[1, 2, 0] = 0.3  # constant: mx == mn, the 1e-8 clamp
    v[0, 7, H - 1] = -1.25
    # quotients on half-way points: scale 1 exactly, values at j + 0.5
    qmax = (1 << bits) - 1
    half = qmax // 2
    if zero_point:  # mn = 0, mx = qmax
        ramp = np.concatenate([[0.0, qmax], np.arange(D - 2) % min(qmax, 127) + 0.5])
    else:  # amax = half
        ramp = np.concatenate([[float(half)], (np.arange(D - 1) % (2 * half)) - half + 0.5])
    k[0, 3, 1 % H] = ramp
    v[2, 18, 0] = -ramp if zero_point else ramp
    if zero_point:  # 1.125's product with the reciprocal rounds apart from
        # its IEEE quotient (7.4999995 / 7.5 at KV4, 127.5 / 127.49999 at KV8)
        k[2, 9, 0] = np.linspace(-1.40625, 3.65625, D)
        k[2, 9, 0, 7] = 1.125
    if zero_point:  # scale (mx - mn) / qmax = 1 + 2^-8: a tie of bf16's RNE
        lo, hi = (0.94140625, 16.0) if bits == 4 else (2.0**-8, 256.0)
        v[1, 5, H - 1] = np.linspace(lo, hi, D)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    return kb, vb, np.array(pages, np.int32), np.array(slots, np.int32)


def _start_cache(H, D, bits, seed):
    t = tkvc.create_kv_cache(L, P, H, PS, D, bits, device="cpu")
    r = np.random.default_rng(seed)
    t.data.copy_(torch.from_numpy(r.integers(-128, 128, t.data.shape).astype(np.int8)))
    t.scales.copy_(torch.from_numpy(r.random(t.scales.shape).astype(np.float32)))
    return t


def _scale_bits(s: torch.Tensor) -> np.ndarray:
    return s.view(torch.int16 if s.element_size() == 2 else torch.int32).numpy()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H", [8, 2])
@pytest.mark.parametrize("zero_point", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_kernel_transcription_equals_jax_and_plain(bits, zero_point, H, D):
    kb, vb, pages, slots = _inputs(H, D, bits, zero_point, seed=bits * 100 + H + D)
    T = len(pages)
    k, v = kb[:, :T], vb[:, :T]  # strided views, as the mixed step passes
    assert not k.is_contiguous()
    start = _start_cache(H, D, bits, seed=H + D)
    # the port's plain chain (what append_all_layers runs on the CPU)
    plain = tkvc.KVCache(start.data.clone(), start.scales.clone())
    tkvc.append_all_layers(plain, k, v, torch.from_numpy(pages),
                           torch.from_numpy(slots), bits, zero_point)
    # the JAX package's XLA quantize and scatter
    jdtype = jnp.bfloat16 if start.scales.dtype == torch.bfloat16 else jnp.float32
    j = jkvc.KVCache(data=jnp.asarray(start.data.numpy()),
                     scales=jnp.asarray(to_np(start.scales)).astype(jdtype))
    j = jkvc.append_all_layers(j, jnp.asarray(to_np(k)).astype(jnp.bfloat16),
                               jnp.asarray(to_np(v)).astype(jnp.bfloat16),
                               jnp.asarray(pages), jnp.asarray(slots), bits,
                               zero_point, max_stages=0)
    jbytes = np.asarray(j.data).view(np.uint8)
    jsc = np.asarray(j.scales).view(np.uint16 if jdtype == jnp.bfloat16 else np.uint32)
    np.testing.assert_array_equal(plain.data.numpy().view(np.uint8), jbytes)
    np.testing.assert_array_equal(_scale_bits(plain.scales).view(jsc.dtype), jsc)
    # the kernel's transcription on both of its paths
    vector = kv_append.launch_shape(L, T, H, D, bits, aligned=True)
    assert vector.lanes == {64: 8, 128: 16}[D]
    for shape in (vector, kv_append.LaunchShape(0, vector.tb), kv_append.LaunchShape(0, 16)):
        data = start.data.numpy().view(np.uint8).copy()
        scales = _scale_bits(start.scales).view(jsc.dtype).copy()
        _kernel_append(data, scales, to_np(k), to_np(v), pages, slots, bits,
                       zero_point, shape)
        np.testing.assert_array_equal(data, jbytes, err_msg=str(shape))
        np.testing.assert_array_equal(scales, jsc, err_msg=str(shape))


@pytest.mark.parametrize("D", [96, 256])
def test_kernel_transcription_other_head_dims(D):
    """D = 96 (12 of a group's 16 lanes hold values, the partner nibble 6
    lanes on) and 256 (a full warp a vector) against the port's plain
    chain, at KV4 with a zero point and KV8 without."""
    for bits, zero_point in ((4, True), (8, False)):
        kb, vb, pages, slots = _inputs(2, D, bits, zero_point, seed=D + bits)
        T = len(pages)
        k, v = kb[:, :T], vb[:, :T]
        start = _start_cache(2, D, bits, seed=D)
        plain = tkvc.KVCache(start.data.clone(), start.scales.clone())
        tkvc.append_plain(plain, k, v, torch.from_numpy(pages),
                          torch.from_numpy(slots), bits, zero_point)
        shape = kv_append.launch_shape(L, T, 2, D, bits, aligned=True)
        assert shape.lanes == {96: 16, 256: 32}[D]
        for s in (shape, shape._replace(lanes=0)):
            data = start.data.numpy().view(np.uint8).copy()
            scales = start.scales.numpy().view(np.uint32).copy()
            _kernel_append(data, scales, to_np(k), to_np(v), pages, slots, bits,
                           zero_point, s)
            np.testing.assert_array_equal(data, plain.data.numpy().view(np.uint8))
            np.testing.assert_array_equal(scales, plain.scales.numpy().view(np.uint32))


@pytest.mark.parametrize("D,bits,aligned,lanes", [
    (64, 4, True, 8), (96, 4, True, 16), (128, 4, True, 16), (256, 4, True, 32),
    (128, 8, True, 16), (72, 8, True, 16), (72, 4, True, 0), (40, 8, True, 8),
    (128, 4, False, 0), (6, 8, True, 0),
])
def test_launch_shape_lanes(D, bits, aligned, lanes):
    """The vector path takes D % 8 (KV4: D % 16) on aligned operands with
    the power of two at or above D / 8 lanes, at least 8; else the scalar
    path. Its lanes cover D / 8 vectors of 8 and the KV4 partner lane (li +
    D / 16) stays inside the group."""
    shape = kv_append.launch_shape(32, 2048, 8, D, bits, aligned)
    assert shape.lanes == lanes
    if lanes:
        assert D // 8 <= lanes <= 32 and lanes & (lanes - 1) == 0
        assert bits == 8 or (D // 16) * 2 <= lanes


def test_launch_shape_tokens_a_block():
    """Prefill grids take 16 tokens a block; a decode batch's blocks hold
    at most 64 vectors (8 kv heads: 4 tokens, 32: 1); 256 kv heads at 16
    tokens would pass 48 KB of shared memory; past what one token fits, the
    wrapper refuses."""
    assert kv_append.launch_shape(32, 2048, 8, 128, 4, True).tb == 16
    assert kv_append.launch_shape(32, 2048, 32, 128, 8, True).tb == 16
    assert kv_append.launch_shape(32, 64, 8, 128, 4, True).tb == 4
    assert kv_append.launch_shape(32, 64, 32, 128, 8, True).tb == 1
    assert kv_append.launch_shape(32, 256, 2, 128, 4, True).tb == 16
    big = kv_append.launch_shape(32, 2048, 256, 128, 4, True)
    assert big.tb < 16 and kv_append.smem_bytes(256, big.tb) <= kv_append.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        kv_append.launch_shape(32, 2048, 4096, 128, 4, True)
    with pytest.raises(ValueError, match="head dim"):
        kv_append.launch_shape(32, 2048, 8, 512, 4, True)
