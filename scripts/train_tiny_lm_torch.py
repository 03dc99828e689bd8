"""Train a small byte-level Llama on the local corpus with the PyTorch port
and save an HF checkpoint (scripts/train_tiny_lm.py's counterpart).

The accuracy goal is ΔPPL(FP16 -> W4A8KV4) measured through the real
converter and serving kernels. No public checkpoint can be downloaded
here, so this trains a real (non-random) model on text found on the
machine (scripts/build_tiny_corpus.py) and writes it as an HF-Llama
directory (config.json + model.safetensors with model.layers.N.* names,
[OC, IC] f32), which scripts/eval_tiny_ppl_torch.py loads, quantizes and
scores through the port's kernels.

The arithmetic is the JAX script's, step for step: bf16 activations and
bf16 casts of the f32 master weights in every matmul, f32 RMSNorm, RoPE
tables, scores, softmax and SiLU, explicit product-softmax-product
attention, bf16-rounded f32 logits; global-norm clipping at 1.0 and AdamW
under optax's warmup-cosine schedule. Random draws come from explicit
torch generators and are not JAX's.

Usage:
  python scripts/build_tiny_corpus.py /tmp/corpus --mb 64
  python scripts/train_tiny_lm_torch.py /tmp/corpus /tmp/tinylm \
      --steps 4000 --batch 64 --seq 512 [--geometry 110m] [--remat] [--device cpu]
  python scripts/eval_tiny_ppl_torch.py /tmp/tinylm /tmp/corpus --optimize
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# byte vocabulary: 0..255 bytes, 256 = BOS; padded to 384
VOCAB = 384
BOS = 256


def model_config(hidden=512, inter=1536, layers=8, heads=4, kv_heads=2):
    return dict(
        architectures=["LlamaForCausalLM"],
        vocab_size=VOCAB,
        hidden_size=hidden,
        intermediate_size=inter,
        num_hidden_layers=layers,
        num_attention_heads=heads,
        num_key_value_heads=kv_heads,
        head_dim=hidden // heads,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        max_position_embeddings=4096,
        model_type="llama",
        torch_dtype="float32",
    )


# Named geometries, as the JAX script has them: "26m" (8 layers), "110m" and
# "400m" (train with --remat) keep head_dim 128, the serving kernels' main path.
GEOMETRIES = {
    "26m": dict(hidden=512, inter=1536, layers=8, heads=4, kv_heads=2),
    "110m": dict(hidden=1024, inter=2816, layers=10, heads=8, kv_heads=2),
    "400m": dict(hidden=1536, inter=4096, layers=16, heads=12, kv_heads=4),
}
# a layer's tensors in the JAX tree's (sorted) order
LAYER_KEYS = ("down", "gate_up", "input_ln", "o", "post_ln", "qkv")


def init_params(generator: torch.Generator, cfg: dict) -> dict:
    """f32 master weights in the JAX script's layout ([in, out] matrices,
    fused qkv [E, (Hq+2Hkv)·D] and gate_up [E, 2I]), drawn on the
    generator's device by the JAX script's law: N(0, 1/fan_in), the
    embedding scaled by sqrt(E)·0.02, norms 1; the layers first, then the
    embedding and the lm_head."""
    E, I, L = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    V, D = cfg["vocab_size"], cfg["head_dim"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dev = generator.device

    def init(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev) / math.sqrt(fan_in)

    layers = []
    for _ in range(L):
        layers.append(dict(
            input_ln=torch.ones(E, device=dev),
            qkv=init((E, (Hq + 2 * Hkv) * D), E),
            o=init((Hq * D, E), Hq * D),
            post_ln=torch.ones(E, device=dev),
            gate_up=init((E, 2 * I), E),
            down=init((I, E), I),
        ))
    return dict(
        embed=init((V, E), E) * math.sqrt(E) * 0.02,
        layers=layers,
        final_ln=torch.ones(E, device=dev),
        lm_head=init((E, V), E),
    )


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """The JAX script's parameter tree (its arrays as numpy) as this
    script's params: the same layout and f32 bits."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return dict(
        embed=t(tree["embed"]),
        layers=[{k: t(fl[k]) for k in LAYER_KEYS} for fl in tree["layers"]],
        final_ln=t(tree["final_ln"]),
        lm_head=t(tree["lm_head"]),
    )


def leaves(params: dict) -> list:
    """Every parameter tensor, in the JAX tree's flattening order."""
    return ([params["embed"], params["final_ln"]]
            + [fl[k] for fl in params["layers"] for k in LAYER_KEYS]
            + [params["lm_head"]])


def causal_mask(T: int, device) -> torch.Tensor:
    return torch.ones((T, T), dtype=torch.bool, device=device).tril()


def _rms(x, w, eps):
    xf = x.float()
    v = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps) * w).to(torch.bfloat16)


def _rope(x, cos, sin):  # [B, T, H, D]
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _layer(h, fl, cfg, cos, sin, mask):
    B, T, _ = h.shape
    D = cfg["head_dim"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    bf16, eps = torch.bfloat16, cfg["rms_norm_eps"]
    x = _rms(h, fl["input_ln"], eps)
    q, k, v = (x @ fl["qkv"].to(bf16)).split([Hq * D, Hkv * D, Hkv * D], dim=-1)
    q = _rope(q.reshape(B, T, Hq, D), cos, sin)
    k = _rope(k.reshape(B, T, Hkv, D), cos, sin).repeat_interleave(Hq // Hkv, dim=2)
    v = v.reshape(B, T, Hkv, D).repeat_interleave(Hq // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(D)
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1).to(bf16)
    attn = torch.einsum("bhts,bshd->bthd", p, v).reshape(B, T, Hq * D)
    h = h + attn @ fl["o"].to(bf16)
    g, u = (_rms(h, fl["post_ln"], eps) @ fl["gate_up"].to(bf16)).chunk(2, dim=-1)
    return h + (F.silu(g.float()).to(bf16) * u) @ fl["down"].to(bf16)


def forward(params: dict, tokens: torch.Tensor, cfg: dict, remat: bool = False):
    """[B, T] int tokens -> logits [B, T, V] (bf16 compute, f32 logits).

    remat=True recomputes each decoder layer on the backward pass
    (torch.utils.checkpoint), as the JAX script's jax.checkpoint does: at
    the 400m geometry the stored [B, H, T, T] attention probabilities of
    every layer are most of the step's memory."""
    T = tokens.shape[1]
    D = cfg["head_dim"]
    h = F.embedding(tokens, params["embed"]).to(torch.bfloat16)
    inv = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(0, D, 2, dtype=torch.float32, device=tokens.device) / D))
    ang = torch.arange(T, dtype=torch.float32, device=tokens.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).to(torch.bfloat16), torch.sin(ang).to(torch.bfloat16)
    mask = causal_mask(T, tokens.device)
    for fl in params["layers"]:
        if remat:
            h = checkpoint(_layer, h, fl, cfg, cos, sin, mask, use_reentrant=False)
        else:
            h = _layer(h, fl, cfg, cos, sin, mask)
    h = _rms(h, params["final_ln"], cfg["rms_norm_eps"])
    return (h @ params["lm_head"].to(torch.bfloat16)).float()


def loss_fn(params: dict, tokens: torch.Tensor, cfg: dict, remat: bool = False):
    """Mean next-token cross-entropy of [B, T+1] rows (a 0-d tensor)."""
    logits = forward(params, tokens[:, :-1], cfg, remat)
    targets = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - tl).mean()


def make_rows(data: torch.Tensor, starts: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T+1] int32 rows [BOS, data[s : s+T]], one per start (the JAX
    script's slice of T+1 bytes behind a BOS, cut to T+1)."""
    idx = starts[:, None] + torch.arange(T, device=data.device)
    bos = torch.full((len(starts), 1), BOS, dtype=torch.int32, device=data.device)
    return torch.cat([bos, data[idx]], dim=1)


def lr_at(step: int, lr: float, warmup: int, steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, steps, 0.1·lr) at
    `step`: lr·t/w over the warmup, then end + (lr - end)·½(1 + cos(π·(t -
    w)/(steps - w))) with end = 0.1·lr."""
    if step < warmup:
        return lr * step / warmup
    end, decay = 0.1 * lr, steps - warmup
    t = min(step - warmup, decay)
    return end + (lr - end) * 0.5 * (1.0 + math.cos(math.pi * t / decay))


def clip_by_global_norm(grads: list, max_norm: float = 1.0) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every g becomes (g / ‖g‖)·max_norm
    when the global norm ‖g‖ (over all tensors) is not below max_norm. The
    norm stays on the device (no read-back); returns it."""
    norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def make_optimizer(params: dict) -> torch.optim.AdamW:
    """optax.adamw(weight_decay=0.01): b1 0.9, b2 0.999, eps 1e-8, decay
    decoupled and applied to every tensor; the lr is set each step."""
    return torch.optim.AdamW(leaves(params), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def train_step(params, opt, rows, cfg, lr, remat=False) -> torch.Tensor:
    """One step of the JAX script's chain: loss and gradients, the global
    clip, AdamW at `lr`. Returns the loss (a device scalar)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(params, rows, cfg, remat)
    loss.backward()
    clip_by_global_norm([p.grad for p in leaves(params)], 1.0)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return loss.detach()


def hf_state(params: dict, cfg: dict) -> dict:
    """{HF name: f32 CPU tensor in [OC, IC]} (the JAX script's split of the
    fused q/k/v and gate/up)."""
    D = cfg["head_dim"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]

    def host(w):
        return w.detach().float().cpu()

    def oc_ic(w):
        return host(w).T.contiguous()

    flat = {
        "model.embed_tokens.weight": host(params["embed"]),
        "model.norm.weight": host(params["final_ln"]),
        "lm_head.weight": oc_ic(params["lm_head"]),
    }
    for li, fl in enumerate(params["layers"]):
        pre = f"model.layers.{li}"
        q, k, v = fl["qkv"].split([Hq * D, Hkv * D, Hkv * D], dim=1)
        g, u = fl["gate_up"].chunk(2, dim=1)
        flat[f"{pre}.self_attn.q_proj.weight"] = oc_ic(q)
        flat[f"{pre}.self_attn.k_proj.weight"] = oc_ic(k)
        flat[f"{pre}.self_attn.v_proj.weight"] = oc_ic(v)
        flat[f"{pre}.self_attn.o_proj.weight"] = oc_ic(fl["o"])
        flat[f"{pre}.mlp.gate_proj.weight"] = oc_ic(g)
        flat[f"{pre}.mlp.up_proj.weight"] = oc_ic(u)
        flat[f"{pre}.mlp.down_proj.weight"] = oc_ic(fl["down"])
        flat[f"{pre}.input_layernorm.weight"] = host(fl["input_ln"])
        flat[f"{pre}.post_attention_layernorm.weight"] = host(fl["post_ln"])
    return flat


def save_checkpoint(params: dict, cfg: dict, out_dir: str) -> None:
    """config.json + model.safetensors, written by the port's own writer."""
    from qserve_tpu_torch.utils.weight_utils import write_safetensors

    os.makedirs(out_dir, exist_ok=True)
    write_safetensors(hf_state(params, cfg), os.path.join(out_dir, "model.safetensors"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


def main(argv=None) -> dict:
    """Trains, saves, and returns {params, losses (every step's), seconds,
    steps_per_s, tokens_per_s (after the first chunk, which warms up),
    peak_gib (None off the card), final_loss}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("corpus_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--chunk", type=int, default=50, help="steps between loss read-backs")
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES), default="26m")
    ap.add_argument("--remat", action="store_true",
                    help="recompute layers on backward (400m)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="init draws from this seed, batch starts from seed + 1")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is available "
                           "(pass --device cpu to train on the host)")
    cfg = model_config(**GEOMETRIES[args.geometry])
    data = np.fromfile(os.path.join(args.corpus_dir, "train.bin"), np.uint8)
    print(f"train corpus: {len(data) / 1e6:.1f} MB")
    data_dev = torch.from_numpy(data.astype(np.int32)).to(dev)

    params = init_params(torch.Generator(dev).manual_seed(args.seed), cfg)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = make_optimizer(params)
    warmup = min(100, args.steps // 4)
    draws = torch.Generator(dev).manual_seed(args.seed + 1)
    B, T = args.batch, args.seq
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    all_losses = []
    t0 = time.perf_counter()
    t_warm = None
    n_chunks = args.steps // args.chunk
    for c in range(n_chunks):
        losses = torch.empty(args.chunk, device=dev)
        for i in range(args.chunk):
            step = c * args.chunk + i
            starts = torch.randint(0, len(data) - T - 1, (B,), generator=draws, device=dev)
            losses[i] = train_step(params, opt, make_rows(data_dev, starts, T), cfg,
                                   lr_at(step, args.lr, warmup, args.steps), args.remat)
        losses = losses.cpu().numpy()  # the chunk's one read-back
        all_losses.append(losses)
        if c == 0:
            t_warm = time.perf_counter()
        print(
            f"step {min((c + 1) * args.chunk, args.steps):5d}  "
            f"loss {losses[-1]:.4f} (mean {losses.mean():.4f})  "
            f"{time.perf_counter() - t0:6.1f}s",
            flush=True,
        )
    seconds = time.perf_counter() - t0
    n_steps = n_chunks * args.chunk
    if n_chunks > 1:
        steps_per_s = (n_steps - args.chunk) / (time.perf_counter() - t_warm)
    else:
        steps_per_s = n_steps / seconds if n_steps else 0.0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    losses = np.concatenate(all_losses) if all_losses else np.zeros(0, np.float32)
    final = float(losses[-args.chunk:].mean()) if n_steps else float("nan")
    print(f"trained {n_steps} steps of {B} x {T} tokens on {args.device} in {seconds:.1f} s: "
          f"{steps_per_s:.3f} steps/s, {steps_per_s * B * T:.0f} tokens/s after the first "
          f"chunk; peak allocated "
          + (f"{peak:.3f} GiB" if peak is not None else "not measured (host)")
          + f"; final loss (last chunk's mean) {final:.4f}", flush=True)

    with torch.no_grad():
        save_checkpoint(params, cfg, args.out_dir)
    print(f"saved HF checkpoint to {args.out_dir}")
    return dict(params=params, cfg=cfg, losses=losses, seconds=seconds,
                steps_per_s=steps_per_s, tokens_per_s=steps_per_s * B * T, peak_gib=peak,
                final_loss=final)


if __name__ == "__main__":
    main()
