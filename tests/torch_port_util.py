"""Shared helpers of the tests/test_torch_*.py parity tests: move numpy data
between the JAX package and its PyTorch port, and build the same tiny
geometry on both sides."""

import jax
import numpy as np
import torch

from qserve_tpu.config import QuantSpec as JQuantSpec
from qserve_tpu.models import llama as jllama
from qserve_tpu_torch.config import QuantSpec as TQuantSpec
from qserve_tpu_torch.convert.from_jax import params_from_numpy, tensor_from_numpy
from qserve_tpu_torch.models import llama as tllama

# tests/test_engine.py's tiny geometry
TINY = dict(
    vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=32,
)


def to_torch(x) -> torch.Tensor:
    """JAX array or numpy array -> CPU torch tensor with the same bits."""
    return tensor_from_numpy(np.asarray(x), "cpu")


def to_np(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy (bf16 widened to f32, exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    tensors of the same sign pattern."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max()) if a.numel() else 0


def tiny_pair(precision="w4a8kv4", seed=0, group_size=-1, lm_head_bits=16,
              **overrides):
    """(JAX args, JAX params, port args, port params) of one tiny model:
    the JAX package makes the random quantized weights (any linear flavor,
    bf16 or W8 lm_head), the port receives them through params_from_numpy."""
    geo = dict(TINY, **overrides)
    spec = dict(group_size=group_size, lm_head_bits=lm_head_bits)
    jargs = jllama.LlamaArgs(quant=JQuantSpec.from_precision(precision, **spec), **geo)
    targs = tllama.LlamaArgs(quant=TQuantSpec.from_precision(precision, **spec), **geo)
    jparams = jllama.random_quantized_params(jax.random.PRNGKey(seed), jargs)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jargs, jparams, targs, tparams
