"""scripts/train_tiny_lm_torch.py against scripts/train_tiny_lm.py and optax
on the CPU, at a tiny geometry (hidden 128, intermediate 256, 2 layers, 2
query heads over 1 kv head, head_dim 64; B 2, T 32): the JAX script's
init_params(PRNGKey(0)) weights carried in through params_from_numpy, the
same rows on both sides. Every tolerance states the gap measured here and
is shown to have teeth: the step without the causal mask fails the
forward, loss, gradient and optimizer limits, and clip_grad_norm_'s rule
(which divides by ‖g‖ + 1e-6) fails the clip limit. Also the HF directory
both scripts write, read back by both packages' loaders, and
scripts/generate_wds_meta_torch.py against scripts/generate_wds_meta.py."""

import importlib.util
import io
import json
import os
import sys
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qserve_tpu.config import QuantSpec as JQ
from qserve_tpu.models import loader as jloader
from qserve_tpu_torch.config import QuantSpec as TQ
from qserve_tpu_torch.models import loader as tloader
from qserve_tpu_torch.utils import weight_utils as wu
import torch_port_util  # noqa: F401  (one torch thread a test process)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden=128, inter=256, layers=2, heads=2, kv_heads=1)
B, T = 2, 32

# measured gaps (this CPU, the seeds below) and the limits set from them
LOGITS_REL_RMS = 1e-5  # measured 9.8e-8 (max |gap| 1.5e-5); no mask: ~1
LOSS_ATOL = 1e-5  # measured 0 (4.8e-7 eager); no mask: 0.105
GRAD_REL = 1e-2  # global relative norm error, measured 2.05e-3; no mask: 1.21
UPDATE_REL = 5e-2  # p3 - p0 after 3 steps, measured 1.35e-2; no mask: 1.20
SCHED_ATOL = 1e-10  # every step of the schedule, measured 4.4e-11 at lr 3e-4
CLIP_RTOL = 2e-7  # of max |g|, measured <= 9.3e-8; clip_grad_norm_ 3.7e-7 to 8.4e-7


def _script(name):
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J = _script("train_tiny_lm")
P = _script("train_tiny_lm_torch")


@pytest.fixture(scope="module")
def setup():
    """cfg, the JAX params, their numpy tree, a byte stream and 3 batches
    of rows (the JAX rule: [BOS, data[s : s+T]])."""
    cfg = J.model_config(**TINY)
    jp = J.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 4096).astype(np.int32)
    rows = [np.stack([np.concatenate([[J.BOS], data[s:s + T]])
                      for s in rng.integers(0, len(data) - T - 1, B)]).astype(np.int32)
            for _ in range(3)]
    return cfg, jp, jax.tree.map(np.asarray, jp), data, rows




def _strict(fn, *args):
    """fn compiled by XLA with every bf16 rounding the code states
    (xla_allow_excess_precision off): bit for bit the op-by-op (eager)
    result, which the port mirrors. The JAX script's own jit keeps some bf16
    steps in f32: its logits sit 8.6e-3 (relative RMS) from these."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})


def _port(npp):
    p = P.params_from_numpy(npp)
    for x in P.leaves(p):
        x.requires_grad_(True)
    return p


def _jax_leaves(tree):
    """The JAX tree's leaves in P.leaves' order (jax.tree.leaves' own)."""
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _rel(got, want):
    num = sum(float(((np.asarray(a, np.float64) - b) ** 2).sum()) for a, b in zip(got, want))
    den = sum(float((np.asarray(b, np.float64) ** 2).sum()) for b in want)
    return (num / den) ** 0.5


@pytest.fixture
def no_mask(monkeypatch):
    """The port's attention without the causal mask (the controls)."""
    monkeypatch.setattr(P, "causal_mask",
                        lambda T, device: torch.ones((T, T), dtype=torch.bool, device=device))


def test_leaves_follow_the_jax_tree(setup):
    cfg, jp, npp, _, _ = setup
    got = [x.detach().numpy() for x in P.leaves(P.params_from_numpy(npp))]
    want = _jax_leaves(jp)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_init_params_layout_and_law(setup):
    """The JAX layout and the JAX script's law (the draws are torch's)."""
    cfg, jp, _, _, _ = setup
    big = J.model_config(hidden=256, inter=512, layers=2, heads=2, kv_heads=1)
    p = P.init_params(torch.Generator().manual_seed(0), big)
    shapes = [tuple(x.shape) for x in P.leaves(p)]
    assert shapes == [x.shape for x in _jax_leaves(J.init_params(jax.random.PRNGKey(0), big))]
    assert all(x.dtype == torch.float32 for x in P.leaves(p))
    E, I = 256, 512
    fl = p["layers"][0]
    for w, fan_in in ((fl["qkv"], E), (fl["o"], E), (fl["gate_up"], E), (fl["down"], I),
                      (p["lm_head"], E)):
        assert abs(float(w.std()) * fan_in**0.5 - 1) < 0.03
    assert abs(float(p["embed"].std()) / 0.02 - 1) < 0.03
    for w in (fl["input_ln"], fl["post_ln"], p["final_ln"]):
        assert torch.equal(w, torch.ones(E))
    again = P.init_params(torch.Generator().manual_seed(0), big)
    assert all(torch.equal(a, b) for a, b in zip(P.leaves(p), P.leaves(again)))


def test_make_rows_matches_the_jax_slice(setup):
    _, _, _, data, _ = setup
    starts = np.array([0, 17, 4096 - T - 2, 1000], np.int32)
    d = jnp.asarray(data)
    sl = jax.vmap(lambda s: jax.lax.dynamic_slice(d, (s,), (T + 1,)))(jnp.asarray(starts))
    want = jnp.concatenate([jnp.full((4, 1), J.BOS, jnp.int32), sl], axis=1)[:, :T + 1]
    got = P.make_rows(torch.from_numpy(data), torch.from_numpy(starts), T)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, T + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _logits_gap(cfg, jp, npp, rows):
    tokens = jnp.asarray(rows[:, :-1])
    want = np.asarray(_strict(lambda p, t: J.forward(p, t, cfg), jp, tokens)(jp, tokens))
    got = P.forward(P.params_from_numpy(npp), torch.from_numpy(rows[:, :-1]), cfg).numpy()
    assert got.shape == want.shape == (B, T, J.VOCAB) and got.dtype == np.float32
    return float(np.sqrt(((got - want) ** 2).mean() / (want**2).mean()))


def test_forward_matches_jax(setup):
    cfg, jp, npp, _, rows = setup
    assert _logits_gap(cfg, jp, npp, rows[0]) < LOGITS_REL_RMS


def test_forward_without_mask_fails(setup, no_mask):
    cfg, jp, npp, _, rows = setup
    assert _logits_gap(cfg, jp, npp, rows[0]) > 100 * LOGITS_REL_RMS


def _value_and_grad(cfg, jp, rows):
    return _strict(lambda p, t: jax.value_and_grad(J.loss_fn)(p, t, cfg), jp, jnp.asarray(rows))


@pytest.fixture(scope="module")
def jax_grads(setup):
    cfg, jp, _, _, rows = setup
    loss, g = _value_and_grad(cfg, jp, rows[0])(jp, jnp.asarray(rows[0]))
    return float(loss), _jax_leaves(g)


def _port_grads(setup, remat=False):
    cfg, _, npp, _, rows = setup
    p = _port(npp)
    loss = P.loss_fn(p, torch.from_numpy(rows[0]), cfg, remat)
    loss.backward()
    return float(loss.detach()), [x.grad.numpy() for x in P.leaves(p)]


def test_loss_and_grads_match_jax(setup, jax_grads):
    loss, grads = _port_grads(setup)
    assert abs(loss - jax_grads[0]) < LOSS_ATOL
    assert _rel(grads, jax_grads[1]) < GRAD_REL


def test_loss_and_grads_without_mask_fail(setup, jax_grads, no_mask):
    loss, grads = _port_grads(setup)
    assert abs(loss - jax_grads[0]) > 100 * LOSS_ATOL
    assert _rel(grads, jax_grads[1]) > 10 * GRAD_REL


def test_remat_is_exact(setup):
    """Recomputing each layer on the backward pass changes no bit."""
    loss, grads = _port_grads(setup)
    loss_r, grads_r = _port_grads(setup, remat=True)
    assert loss_r == loss
    for a, b in zip(grads_r, grads):
        np.testing.assert_array_equal(a, b)


STEPS_LR = (8, 3e-4)  # warmup 2: the 3 steps run at lr 0, lr/2, lr


@pytest.fixture(scope="module")
def optax_updates(setup):
    """p3 - p0 of the JAX script's chain over the 3 batches."""
    cfg, jp, _, _, rows = setup
    value_and_grad = _value_and_grad(cfg, jp, rows[0])
    steps, lr = STEPS_LR
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, min(100, steps // 4), steps, lr * 0.1)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=0.01))
    update = jax.jit(lambda g, state, p: opt.update(g, state, p))  # f32 only
    p, state = jp, opt.init(jp)
    for r in rows:
        _, g = value_and_grad(p, jnp.asarray(r))
        u, state = update(g, state, p)
        p = optax.apply_updates(p, u)
    return [a - b for a, b in zip(_jax_leaves(p), _jax_leaves(jp))]


def _port_updates(setup):
    cfg, _, npp, _, rows = setup
    steps, lr = STEPS_LR
    p = _port(npp)
    opt = P.make_optimizer(p)
    for i, r in enumerate(rows):
        P.train_step(p, opt, torch.from_numpy(r), cfg, P.lr_at(i, lr, min(100, steps // 4), steps))
    return [a.detach().numpy() - b for a, b in zip(P.leaves(p), _jax_leaves(setup[1]))]


def test_three_steps_match_optax(setup, optax_updates):
    assert _rel(_port_updates(setup), optax_updates) < UPDATE_REL


def test_three_steps_without_mask_fail(setup, optax_updates, no_mask):
    assert _rel(_port_updates(setup), optax_updates) > 10 * UPDATE_REL


@pytest.mark.parametrize("steps", [1, 8, 4000])
def test_schedule_matches_optax(steps):
    lr = 3e-4
    warmup = min(100, steps // 4)
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.1)
    want = np.asarray(jax.vmap(sched)(jnp.arange(steps)), np.float64)
    got = np.array([P.lr_at(t, lr, warmup, steps) for t in range(steps)])
    assert np.abs(got - want).max() < SCHED_ATOL
    if steps > 1:  # off by one step fails
        late = np.array([P.lr_at(t + 1, lr, warmup, steps) for t in range(steps)])
        assert np.abs(late - want).max() > 100 * SCHED_ATOL


@pytest.mark.parametrize("norm", [0.5, 1.0, 1.25, 3.0, 40.0])
def test_clip_matches_optax(norm):
    rng = np.random.default_rng(1)
    gs = [rng.standard_normal(s) for s in [(64, 32), (32,), (17, 5)]]
    total = np.sqrt(sum((g**2).sum() for g in gs))
    gs = [(g / total * norm).astype(np.float32) for g in gs]
    clip = optax.clip_by_global_norm(1.0)
    want, _ = clip.update([jnp.asarray(g) for g in gs], clip.init(None))
    want = [np.asarray(w) for w in want]
    scale = max(np.abs(w).max() for w in want)

    got = [torch.from_numpy(g.copy()) for g in gs]
    P.clip_by_global_norm(got, 1.0)
    gap = max(np.abs(g.numpy() - w).max() for g, w in zip(got, want)) / scale
    assert gap < CLIP_RTOL
    # torch's clip_grad_norm_ (max_norm / (‖g‖ + 1e-6), capped at 1) fails
    # wherever the 1e-6 moves the scale: from ‖g‖ = 1 - 1e-6 to a few
    ts = [torch.zeros(g.shape, requires_grad=True) for g in gs]
    for t, g in zip(ts, gs):
        t.grad = torch.from_numpy(g.copy())
    torch.nn.utils.clip_grad_norm_(ts, 1.0)
    lib_gap = max(np.abs(t.grad.numpy() - w).max() for t, w in zip(ts, want)) / scale
    if 1.0 <= norm <= 3.0:
        assert lib_gap > CLIP_RTOL


def _corpus(d, n=1 << 16):
    """train.bin of the repo's own text (real bytes: the loss can fall)."""
    os.makedirs(d, exist_ok=True)
    text = b""
    for name in ("README.md", "ROADMAP.md", "PERF.md", "CLAUDE.md"):
        with open(os.path.join(ROOT, name), "rb") as f:
            text += f.read()
    np.frombuffer(text[:n], np.uint8).tofile(os.path.join(d, "train.bin"))
    return d


@pytest.fixture
def tiny_geometry(monkeypatch):
    monkeypatch.setitem(P.GEOMETRIES, "tiny", TINY)
    monkeypatch.setitem(J.GEOMETRIES, "tiny", TINY)


def test_cpu_run_loss_falls(tmp_path, tiny_geometry, capsys):
    corpus = _corpus(str(tmp_path / "corpus"))
    out = str(tmp_path / "ckpt")
    r = P.main([corpus, out, "--steps", "20", "--chunk", "5", "--batch", "4", "--seq", "32",
                "--lr", "3e-3", "--geometry", "tiny", "--device", "cpu"])
    losses = r["losses"]
    assert losses.shape == (20,) and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean() - 0.5, losses
    assert r["final_loss"] == pytest.approx(float(losses[-5:].mean()))
    assert r["peak_gib"] is None and r["steps_per_s"] > 0
    printed = capsys.readouterr().out
    assert [ln.split()[1] for ln in printed.splitlines() if ln.startswith("step ")] == [
        "5", "10", "15", "20"]
    assert "peak allocated not measured (host)" in printed
    loaded = tloader.load_float_params_from_hf(
        out, tloader.args_from_config_dict(r["cfg"], TQ.from_precision("w16a16kv8")))
    for a, b in zip(P.leaves(loaded), P.leaves(r["params"])):
        assert torch.equal(a, b.detach())


def test_cuda_device_without_cuda_raises(tmp_path, monkeypatch):
    """The default --device cuda never falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus = _corpus(str(tmp_path / "corpus"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main([corpus, str(tmp_path / "ckpt"), "--steps", "2", "--chunk", "1"])
    assert not os.path.exists(tmp_path / "ckpt")


def test_checkpoint_layout_matches_the_jax_script(tmp_path, tiny_geometry, monkeypatch, setup):
    """The JAX script at --steps 1 --chunk 2 runs no step and saves its init
    params (PRNGKey(0)); the port saves the same params: the same names,
    shapes, dtypes and bytes, the same config, and both packages' loaders
    read the port's directory to the same arrays."""
    corpus = _corpus(str(tmp_path / "corpus"))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["train_tiny_lm.py", corpus, jdir, "--steps", "1",
                                      "--chunk", "2", "--geometry", "tiny"])
    J.main()
    cfg = P.model_config(**TINY)
    jp = J.init_params(jax.random.PRNGKey(0), cfg)
    P.save_checkpoint(P.params_from_numpy(jax.tree.map(np.asarray, jp)), cfg, tdir)

    with open(os.path.join(jdir, "config.json")) as f, open(os.path.join(tdir, "config.json")) as g:
        assert json.load(f) == json.load(g) == cfg
    want = wu.read_safetensors(os.path.join(jdir, "model.safetensors"))
    got = wu.read_safetensors(os.path.join(tdir, "model.safetensors"))
    assert sorted(got) == sorted(want) and len(got) == 3 + 9 * TINY["layers"]
    for name, w in want.items():
        assert got[name].dtype == w.dtype == torch.float32, name
        assert got[name].shape == w.shape, name
        assert bytes(got[name].numpy().data) == bytes(w.numpy().data), name

    jargs = jloader.args_from_config_dict(cfg, JQ.from_precision("w16a16kv8"))
    targs = tloader.args_from_config_dict(cfg, TQ.from_precision("w16a16kv8"))
    from_jax = jloader.load_float_params_from_hf(tdir, jargs)
    from_port = tloader.load_float_params_from_hf(tdir, targs)
    for a, b, c in zip(_jax_leaves(from_jax), P.leaves(from_port), _jax_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(b.numpy(), c)


def _shard(path, samples):
    with tarfile.open(path, "w") as tf:
        for name, data in samples:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def test_generate_wds_meta_matches_the_jax_script(tmp_path, monkeypatch):
    for i, samples in enumerate([
        [("a.jpg", b"\xff\xd8jpg"), ("a.txt", b"one"), ("b.png", b"\x89PNG"),
         ("c.json", b'{"k": 1}'), ("c.txt", b"no image"), ("d.webp", b"RIFF")],
        [("e.txt", b"text only"), ("f.jpeg", b"\xff\xd8"), ("f.json", b"{}")],
    ]):
        _shard(str(tmp_path / f"s-{i:05d}.tar"), samples)
    pattern = str(tmp_path / "s-{00000..00001}.tar")
    monkeypatch.setattr(sys, "argv", ["generate_wds_meta.py", pattern, str(tmp_path / "jax.json")])
    _script("generate_wds_meta").main()
    _script("generate_wds_meta_torch").main([pattern, str(tmp_path / "port.json")])
    with open(tmp_path / "jax.json", "rb") as f, open(tmp_path / "port.json", "rb") as g:
        want, got = f.read(), g.read()
    assert got == want
    assert [e["nsamples"] for e in json.loads(got)["shardlist"]] == [3, 1]
