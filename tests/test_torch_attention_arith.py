"""The arithmetic of the tensor-core prefill kernels, transcribed in torch
and held on the CPU before any card runs them.

K3 (csrc/flash_attention.cu): 64-key tiles from the start of the query
tile's first segment (or the window's lower edge) to its causal limit,
scores in the log2 domain, m and l in f32 from the unrounded p, P rounded to
bf16 for PV. K6 (csrc/prefix_attention.cu): the prefix in the code domain,
q.k = sc (q.c) + z sum(q) with raw codes c, PV as bf16-rounded p * sc against
raw V codes plus sum(p * z) (codes centred on 0: KV4 n - 8, KV8 the signed
byte u - 128, the offset times sc folded into the zero), then the chunk's own keys as K3 (bf16 P), one softmax through both.

Each transcription is held (a) within the limit `chip_smoke.py` holds the
kernels to against their plain versions, `within_chip_limit`, and (b)
within ATOL of the JAX package's XLA fallback, at the CPU shapes of
tests/test_torch_attention.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qserve_tpu.kernels import attention as jattn
from qserve_tpu_torch.kernels import attention as tattn
from test_torch_attention import ATOL, _bf16, _chunk, _filled_cache
from torch_port_util import to_np

LOG2E = 1.4426950408889634
NEG_INF = -1e30
BK = 64  # keys per tile
# chip_smoke.py's limit for K3 and K6: one bf16 step of each value plus
# this fraction of the largest output (bf16 P and bf16 p * sc need up to
# 1.3e-3 at these and 4x larger shapes; K4 is held at 1e-3)
CHIP_FLOOR = 3e-3


def within_chip_limit(got, want):
    """|got - want| <= 2^-7 |want| + CHIP_FLOOR max|want|, elementwise."""
    got, want = got.float(), want.float()
    limit = 2.0**-7 * want.abs() + CHIP_FLOOR * want.abs().max()
    return bool(((got - want).abs() <= limit).all())


def _merge(state, s, mask, w_of_p, vals, z_of_p=None):
    """One tile into the running softmax state (m, l, z, acc) [Hq, n, .]:
    s the log2-domain scores [Hq, n, k], w_of_p(p) the PV weights (rounded
    to bf16 here), vals [Hq, k, D]."""
    m, l, z, acc = state
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    mn = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp2(m - mn)
    p = torch.where(mask, torch.exp2(s - mn), torch.zeros_like(s))
    l = l * alpha + p.sum(-1, keepdim=True)
    z = z * alpha + (z_of_p(p) if z_of_p else 0.0)
    w = w_of_p(p).to(torch.bfloat16).float()
    acc = acc * alpha + torch.einsum("hnk,hkd->hnd", w, vals)
    return mn, l, z, acc


def _fresh(Hq, n, D):
    return (torch.full((Hq, n, 1), NEG_INF), torch.zeros(Hq, n, 1),
            torch.zeros(Hq, n, 1), torch.zeros(Hq, n, D))


def flash_arith(q, k, v, seg, sm, window=None):
    T, Hq, D = q.shape
    rep = Hq // k.shape[1]
    bq = 64 // rep
    c = sm * LOG2E
    qf = q.float().transpose(0, 1)
    kf = k.float().repeat_interleave(rep, 1).transpose(0, 1)
    vf = v.float().repeat_interleave(rep, 1).transpose(0, 1)
    segl = seg.tolist()
    out = torch.zeros(T, Hq, D)
    for q0 in range(0, T, bq):
        rows = torch.arange(q0, min(q0 + bq, T))
        kstart = q0
        if segl[q0] > 0:
            while kstart > 0 and segl[kstart - 1] == segl[q0]:
                kstart -= 1
        if window:
            kstart = max(kstart, q0 - window + 1)
        st = _fresh(Hq, len(rows), D)
        for k0 in range(kstart, int(rows[-1]) + 1, BK):
            keys = torch.arange(k0, min(k0 + BK, T))
            s = torch.einsum("hnd,hkd->hnk", qf[:, rows], kf[:, keys]) * c
            mask = ((seg[keys][None] == seg[rows][:, None]) & (seg[rows] > 0)[:, None]
                    & (keys[None] <= rows[:, None]))
            if window:
                mask = mask & (keys[None] > rows[:, None] - window)
            st = _merge(st, s, mask[None], lambda p: p, vf[:, keys])
        m, l, z, acc = st
        out[rows] = (acc / l.clamp(min=1e-30)).transpose(0, 1)
    return out.to(torch.bfloat16)


def prefix_arith(q, k, v, seg, pos, cache, table, prefix_len, li, kv_bits, sm,
                 window=None):
    T, Hq, D = q.shape
    H = k.shape[1]
    rep = Hq // H
    c = sm * LOG2E
    layer = cache.layer(li)
    ps = layer.page_size
    s_all = torch.arange(prefix_len)
    pages, slots = table[0][s_all // ps].long(), s_all % ps
    d = layer.data[pages, :, slots].int().reshape(prefix_len, 2, H, -1)
    # codes centred on 0 (KV4 n - 8, KV8 the stored byte u - 128), the
    # offset times the scale folded into the zero
    if kv_bits == 4:  # dims [0, D/2) low nibbles, [D/2, D) high
        d = d & 0xFF
        codes, off = torch.cat([d & 0xF, d >> 4], -1) - 8, 8
    else:
        codes, off = d, 128
    sc = layer.scales[pages, :, :, slots].float()  # [S, 2, 2H]
    ksc, kz, vsc, vz = sc[:, 0, :H], sc[:, 0, H:], sc[:, 1, :H], sc[:, 1, H:]
    kz, vz = kz + off * ksc, vz + off * vsc

    def per_q(x):  # [S, H] -> [Hq, 1, S]
        return x.repeat_interleave(rep, 1).T[:, None, :]

    kc = codes[:, 0].float().repeat_interleave(rep, 1).transpose(0, 1)  # [Hq, S, D]
    vc = codes[:, 1].float().repeat_interleave(rep, 1).transpose(0, 1)
    ksc, kz, vsc, vz = (per_q(x) for x in (ksc, kz, vsc, vz))
    qf = q.float().transpose(0, 1)  # [Hq, T, D]
    sqc = qf.sum(-1, keepdim=True) * c  # [Hq, T, 1]
    live = seg > 0
    qp = torch.where(live, pos, -1)

    def visible(kp):
        mask = kp[None] <= qp[:, None]
        if window:
            mask = mask & (kp[None] > qp[:, None] - window)
        return mask[None]

    st = _fresh(Hq, T, D)
    for s0 in range(0, prefix_len, BK):
        j = torch.arange(s0, min(s0 + BK, prefix_len))
        s = torch.einsum("htd,hkd->htk", qf, kc[:, j]) * (ksc[..., j] * c) + kz[..., j] * sqc
        st = _merge(st, s, visible(j), lambda p: p * vsc[..., j], vc[:, j],
                    lambda p: (p * vz[..., j]).sum(-1, keepdim=True))
    kp_all = torch.where(live, pos, torch.iinfo(torch.int32).max)
    kf = k.float().repeat_interleave(rep, 1).transpose(0, 1)
    vf = v.float().repeat_interleave(rep, 1).transpose(0, 1)
    for k0 in range(0, T, BK):
        j = torch.arange(k0, min(k0 + BK, T))
        s = torch.einsum("htd,hkd->htk", qf, kf[:, j]) * c
        st = _merge(st, s, visible(kp_all[j]), lambda p: p, vf[:, j])
    m, l, z, acc = st
    return ((acc + z) / l.clamp(min=1e-30)).transpose(0, 1).to(torch.bfloat16)


SEGS = {"three prompts": [20, 9, 13], "two prompts, rep 3": [30, 12]}


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("case", ["three prompts", "two prompts, rep 3"])
def test_flash_arith(case, window):
    """K3's arithmetic against the plain version (chip limit) and the JAX
    fallback (ATOL); a rep of 3 leaves one of the 64 folded rows dead."""
    T, D = 48, 32
    Hq, Hkv = (4, 2) if case == "three prompts" else (6, 2)
    (qt, qj), (kt, kj), (vt, vj) = (_bf16((T, h, D), s) for s, h in
                                    ((0, Hq), (1, Hkv), (2, Hkv)))
    seg = np.zeros(T, np.int32)  # the prompts, then padding
    seg[:sum(SEGS[case])] = np.repeat(np.arange(1, len(SEGS[case]) + 1), SEGS[case])
    seg_t = torch.from_numpy(seg)
    sm = 1.0 / D**0.5
    got = flash_arith(qt, kt, vt, seg_t, sm, window)
    live = seg > 0
    assert not got[~torch.from_numpy(live)].any(), "padding rows come out 0"
    plain = tattn.prefill_attention_plain(qt, kt, vt, seg_t, sm, window)
    assert within_chip_limit(got[live], plain[live])
    want = jattn.prefill_attention(qj, kj, vj, jnp.asarray(seg), sliding_window=window)
    np.testing.assert_allclose(to_np(got)[live], np.asarray(want, np.float32)[live],
                               atol=ATOL)


@pytest.mark.parametrize("kv_bits,H,rep", [(4, 8, 2), (4, 2, 2), (8, 8, 2), (8, 2, 3),
                                           (8, 4, 1)])  # H 2: f32 scales
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("prefix_len", [64, 97])
def test_prefix_arith(prefix_len, window, kv_bits, H, rep):
    """K6's code-domain arithmetic against the plain version (chip limit)
    and the JAX fallback (ATOL), KV4 and KV8, bf16 and f32 scales."""
    L, P, ps, D, T, live = 2, 12, 16, 32, 48, 41
    cache, jcache = _filled_cache(L, P, H, ps, D, seed=H + prefix_len, kv_bits=kv_bits)
    bt = np.zeros((1, 10), np.int32)
    bt[0, :7] = [5, 0, 9, 3, 11, 7, 2]
    ((qt, qj), (kt, kj), (vt, vj)), seg, pos = _chunk(T, live, H * rep, H, D,
                                                      prefix_len)
    args = (qt, kt, vt, torch.from_numpy(seg), torch.from_numpy(pos), cache,
            torch.from_numpy(bt), prefix_len, 1, kv_bits)
    sm = 1.0 / D**0.5
    got = prefix_arith(*args, sm, window)
    assert not got[live:].any(), "padding rows come out 0"
    plain = tattn.prefix_prefill_attention_plain(*args, sm, window)
    assert within_chip_limit(got[:live], plain[:live])
    want = jattn.prefix_prefill_attention(
        qj, kj, vj, jnp.asarray(seg), jnp.asarray(pos), jcache, jnp.asarray(bt),
        jnp.int32(prefix_len), jnp.int32(1), kv_bits, sliding_window=window,
    )
    np.testing.assert_allclose(to_np(got)[:live], np.asarray(want, np.float32)[:live],
                               atol=ATOL)


def test_chip_limit_has_teeth():
    """The plain prefix output with the last 64-key tile of the prefix cut
    off fails the limit on some live element."""
    H, rep, D, T, live, S = 2, 2, 32, 48, 41, 160
    cache, _ = _filled_cache(1, 12, H, 16, D, seed=3)
    bt = torch.arange(10, dtype=torch.int32)[None]
    ((qt, _), (kt, _), (vt, _)), seg, pos = _chunk(T, live, H * rep, H, D, S)
    args = (qt, kt, vt, torch.from_numpy(seg), torch.from_numpy(pos), cache, bt)
    full = tattn.prefix_prefill_attention_plain(*args, S, 0, 4)
    cut = tattn.prefix_prefill_attention_plain(*args, S - BK, 0, 4)
    assert within_chip_limit(prefix_arith(*args, S, 0, 4, 1 / D**0.5)[:live], full[:live])
    assert not within_chip_limit(cut[:live], full[:live])


@pytest.mark.parametrize("precision,group_size", [("w4a8kv4", -1), ("w4a8kv4", 128),
                                                  ("w8a8kv8", -1), ("w16a16kv8", -1)])
def test_router_shift_from_bf16_p(precision, group_size, monkeypatch):
    """A witness on the CPU for the router check of chip_smoke.py's small
    Mixtral: its model and packed prefill (prompts of 37 and 20 tokens, 7
    rows of padding) through K3's arithmetic (bf16 P), then through the
    plain attention following the first run's routing, as the CPU follows
    the card's there. The router probabilities of the live tokens move, as
    they do between the card and the CPU, by less than the card is held
    to."""
    from chip_smoke import ROUTER_ATOL, MoERecorder
    from qserve_tpu_torch.config import QuantSpec
    from qserve_tpu_torch.kernels import kv_cache as kvc
    from qserve_tpu_torch.models import llama, mixtral

    quant = QuantSpec.from_precision(precision, group_size)
    args = llama.LlamaArgs(quant=quant, vocab_size=512, hidden_size=256,
                           intermediate_size=512, num_layers=2, num_heads=4,
                           num_kv_heads=2, head_dim=64, num_experts=4, moe_top_k=2,
                           moe_route_block=128, moe_route_min_tokens=16)
    params = mixtral.random_quantized_params(0, args, device="cpu")
    T, ps, lens = 64, 16, [37, 20]
    rng = np.random.default_rng(7)
    tok = np.zeros(T, np.int32)
    tok[:57] = rng.integers(1, 512, 57)
    pos = np.concatenate([np.arange(37), np.arange(20), np.zeros(7)])
    seg = np.repeat([1, 2, 0], lens + [7])
    pages = np.array([i // ps for i in range(37)] + [3 + i // ps for i in range(20)]
                     + [-1] * 7)
    slots = np.concatenate([np.arange(37) % ps, np.arange(20) % ps, np.zeros(7)])
    inp = [torch.from_numpy(x.astype(np.int32))
           for x in (tok, pos, seg, pages, slots, np.array([36, 56]))]
    live = torch.from_numpy(seg > 0)

    def run():
        cache = kvc.create_kv_cache(2, 10, 2, ps, 64, quant.kv_bits, device="cpu")
        return llama.prefill(params, cache, *inp, args)[0]

    plain = tattn.prefill_attention_plain
    with MoERecorder(probs=True) as rec:
        monkeypatch.setattr(tattn, "prefill_attention_plain",
                            lambda q, k, v, seg, sm=None, window=None: flash_arith(
                                q, k, v, seg, sm or q.shape[-1] ** -0.5, window))
        arith = run()
        monkeypatch.setattr(tattn, "prefill_attention_plain", plain)
        rec.side = "follow"
        want = run()
    assert len(rec.probs["follow"]) == len(rec.probs["lead"]) == args.num_layers
    moved = max((a - b)[live].abs().max().item()
                for a, b in zip(rec.probs["lead"], rec.probs["follow"]))
    flips = sum(int((f & live).sum()) for f in rec.forced)
    rel = (want - arith).abs().max().item() / want.abs().max().item()
    print(f"{precision} g{group_size}: router probabilities move by up to {moved:.3g}, "
          f"{flips} live tokens follow the first run's experts; logits differ by {rel:.3g} "
          f"of their range")
    assert 0 < moved < ROUTER_ATOL
    assert rel <= 0.05


# ---------------------------------------------------------------------------
# K4 (csrc/paged_attention.cu): flash-decoding. Each (sequence, kv head)'s
# history, from the 64-key chunk holding its first visible key, is cut into
# ns runs of whole chunks; each run keeps its own online softmax in the code
# domain (q.k = sc (q.c) + zp sum(q) with raw codes: KV4 n, KV8 u; PV as
# (p * v_scale) . c plus sum(p * v_zero), all f32); the runs and the current
# token then merge as finish_rows does. K4 is held to one bf16 step plus
# 1e-3 of the largest output on the card.
# ---------------------------------------------------------------------------

K4_FLOOR = 1e-3


def paged_arith(q, cache, bt, ctx, li, k_cur, v_cur, kv_bits, sm, window, ns):
    B, Hq, D = q.shape
    H = k_cur.shape[1]
    rep = Hq // H
    layer = cache.layer(li)
    ps = layer.page_size
    out = torch.zeros(B, Hq, D)
    for b in range(B):
        hist = max(int(ctx[b]) - 1, 0)
        kbeg = max(0, hist - window + 1) if window else 0
        a0 = kbeg // BK * BK
        nch = -(-(hist - a0) // BK)
        per = -(-nch // ns)
        for h in range(H):
            qf = q[b, h * rep:(h + 1) * rep].float()  # [rep, D]
            qsum = qf.sum(-1)
            states = []
            for split in range(ns):
                cs = a0 + split * per * BK
                ce = min(hist, cs + per * BK)
                m = torch.full((rep,), NEG_INF)
                l, z, acc = torch.zeros(rep), torch.zeros(rep), torch.zeros(rep, D)
                for c0 in range(cs, ce, BK):
                    s_ = torch.arange(c0, min(c0 + BK, ce))
                    s_ = s_[s_ >= kbeg]
                    if len(s_) == 0:
                        continue
                    pages = bt[b, s_ // ps].long()
                    d = layer.data[pages, :, s_ % ps].int()[:, :, h * D * kv_bits // 8:
                                                            (h + 1) * D * kv_bits // 8]
                    if kv_bits == 4:
                        d = d & 0xFF
                        codes = torch.cat([d & 0xF, d >> 4], -1).float()
                    else:
                        codes = (d + 128).float()
                    sc = layer.scales[pages, :, :, s_ % ps].float()  # [n, 2, 2H]
                    ksc, kzp, vsc, vzp = sc[:, 0, h], sc[:, 0, H + h], sc[:, 1, h], sc[:, 1, H + h]
                    s = sm * (ksc * (qf @ codes[:, 0].T) + kzp * qsum[:, None])  # [rep, n]
                    mn = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - mn)
                    p = torch.exp(s - mn[:, None])
                    l = l * alpha + p.sum(-1)
                    z = z * alpha + (p * vzp).sum(-1)
                    acc = acc * alpha[:, None] + (p * vsc) @ codes[:, 1]
                    m = mn
                states.append((m, l, acc + z[:, None]))
            sc_cur = sm * (qf @ k_cur[b, h].float())  # [rep]
            mx = torch.stack([sc_cur] + [st[0] for st in states]).amax(0)
            pc = torch.exp(sc_cur - mx)
            num = pc[:, None] * v_cur[b, h].float()[None]
            den = pc.clone()
            for m, l, o in states:
                w = torch.exp(m - mx)
                num = num + w[:, None] * o
                den = den + w * l
            out[b, h * rep:(h + 1) * rep] = num / den[:, None]
    return out.to(torch.bfloat16)


def _k4_within(got, want):
    got, want = got.float(), want.float()
    limit = 2.0**-7 * want.abs() + K4_FLOOR * want.abs().max()
    return bool(((got - want).abs() <= limit).all())


@pytest.mark.parametrize("kv_bits,H,rep", [(4, 8, 2), (4, 2, 4), (8, 8, 2), (8, 4, 1)])
@pytest.mark.parametrize("window", [None, 70])
@pytest.mark.parametrize("ns", [1, 3])
def test_paged_arith(ns, window, kv_bits, H, rep):
    """K4's split-and-merge order against the plain version (its chip limit)
    and the JAX fallback (ATOL), one and three splits, KV4 and KV8, bf16 and
    f32 scales (H 2, 4), a window across chunk edges."""
    L, P, ps, D = 2, 12, 16, 32
    B, Hq = 5, H * rep
    cache, jcache = _filled_cache(L, P, H, ps, D, seed=H + ns, kv_bits=kv_bits)
    bt = np.array([[3, 1, 7, 10, 4, 6, 2, 8, 0, 5], [0, 2, 0, 0, 0, 0, 0, 0, 0, 0],
                   [5, 0, 0, 0, 0, 0, 0, 0, 0, 0], [9, 8, 6, 11, 1, 0, 0, 0, 0, 0],
                   [0] * 10], np.int32)
    ctx = np.array([158, 17, 1, 70, 0], np.int32)  # 157 and 69 history keys
    (qt, qj), (kt, kj), (vt, vj) = (_bf16((B, h, D), s) for s, h in
                                    ((3, Hq), (4, H), (5, H)))
    sm = 1.0 / D**0.5
    got = paged_arith(qt, cache, torch.from_numpy(bt), ctx, 1, kt, vt, kv_bits, sm,
                      window, ns)
    plain = tattn.paged_decode_attention_plain(
        qt, cache, torch.from_numpy(bt), torch.from_numpy(ctx), 1, kt, vt, kv_bits,
        sm, window)
    assert _k4_within(got, plain)
    want = jattn.paged_decode_attention(qj, jcache, jnp.asarray(bt), jnp.asarray(ctx),
                                        1, kj, vj, kv_bits, sliding_window=window)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), atol=ATOL)
