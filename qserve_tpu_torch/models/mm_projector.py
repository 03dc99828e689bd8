"""Multimodal projector: vision features -> LLM embedding space
(qserve_tpu/models/mm_projector.py).

llava's `linear` / `mlpNx_gelu` and VILA's `mlp_downsample` (a 2x2 spatial
concat before a 2-layer MLP: a 24-grid becomes 144 tokens an image, a
27-grid, padded to 28, 196). Weights are plain [in, out] matrices in the
compute dtype, multiplied with an f32 result; the bias is added in f32 and
the exact GELU runs in f32, as in the JAX package. Library PyTorch on
every device (XLA in the JAX package).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from qserve_tpu_torch.models.clip import matmul_f32, state_tensor
from qserve_tpu_torch.utils.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class ProjectorArgs:
    kind: str  # "linear" | "mlpNx_gelu" | "mlp_downsample"
    vision_hidden: int
    llm_hidden: int
    grid: int  # vision patch grid (per side)
    compute_dtype: Any = torch.bfloat16

    @property
    def downsample(self) -> bool:
        return "downsample" in self.kind

    @property
    def num_mlp_layers(self) -> int:
        m = re.match(r"mlp(\d+)x_gelu", self.kind)
        if m:
            return int(m.group(1))
        return 2 if self.downsample else 1

    @property
    def out_grid(self) -> int:
        return -(-self.grid // 2) if self.downsample else self.grid

    @property
    def tokens_per_image(self) -> int:
        return self.out_grid * self.out_grid

    @property
    def in_features(self) -> int:
        return self.vision_hidden * (4 if self.downsample else 1)


class ProjectorParams(NamedTuple):
    weights: Any  # tuple of [in, out] matrices
    biases: Any  # tuple of f32 [out] vectors (or None)


def downsample_2x2(x: torch.Tensor, grid: int) -> torch.Tensor:
    """[B, grid*grid, D] -> [B, ceil(grid/2)^2, 4*D] (VILA mlp_downsample).

    Odd grids are zero-padded on the bottom/right edge before the 2x2
    neighborhood concat."""
    B, N, D = x.shape
    assert N == grid * grid
    g2 = -(-grid // 2) * 2
    xi = x.reshape(B, grid, grid, D)
    if g2 != grid:
        xi = F.pad(xi, (0, 0, 0, g2 - grid, 0, g2 - grid))
    xi = xi.reshape(B, g2 // 2, 2, g2 // 2, 2, D)
    xi = xi.permute(0, 1, 3, 2, 4, 5)  # [B, g/2, g/2, 2, 2, D]
    return xi.reshape(B, (g2 // 2) * (g2 // 2), 4 * D)


def apply_projector(
    params: ProjectorParams, feats: torch.Tensor, args: ProjectorArgs
) -> torch.Tensor:
    """[B, num_patches, Dv] -> [B, tokens_per_image, E_llm] in compute_dtype."""
    dt = args.compute_dtype
    x = feats.to(dt)
    if args.downsample:
        x = downsample_2x2(x, args.grid)
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        if i > 0:
            x = F.gelu(x.to(torch.float32)).to(dt)
        y = matmul_f32(x, w.to(dt))
        if b is not None:
            y = y + b
        x = y.to(dt)
    return x


def params_from_hf_state(state: dict, args: ProjectorArgs, device="cuda") -> ProjectorParams:
    """From llava/VILA checkpoint keys: model.mm_projector.{i}.weight/bias
    (sequential indices skip the GELUs), or mm_projector.* without prefix.
    Every indexed weight must be a linear's (2-D): a LayerNorm's raises."""
    device = resolve_device(device)
    items = {}
    for k, v in state.items():
        m = re.search(r"mm_projector\.(?:layers\.)?(\d+)\.(weight|bias)", k)
        if m:
            items[(int(m.group(1)), m.group(2))] = state_tensor(v)
        elif re.search(r"mm_projector\.(weight|bias)$", k):  # bare linear
            items[(0, k.rsplit(".", 1)[1])] = state_tensor(v)
    idxs = sorted({i for i, _ in items})
    weights, biases = [], []
    for i in idxs:
        if items[(i, "weight")].dim() != 2:
            # VILA's mlp_downsample has LayerNorm(4 * D) at layers.1
            raise NotImplementedError(
                f"mm_projector layer {i} has a {items[(i, 'weight')].dim()}-D weight: a "
                "LayerNorm (VILA's mlp_downsample keeps one at layers.1), which this "
                "projector does not serve (ROADMAP, standing VLM divergences)")
        weights.append(items[(i, "weight")].T.to(device=device, dtype=args.compute_dtype)
                       .contiguous())
        b = items.get((i, "bias"))
        biases.append(None if b is None else b.to(device=device, dtype=torch.float32))
    assert weights, "no mm_projector weights found"
    return ProjectorParams(weights=tuple(weights), biases=tuple(biases))


def random_params(
    gen: torch.Generator, args: ProjectorArgs, device="cuda", scale: float = 0.02
) -> ProjectorParams:
    device = resolve_device(device)
    dims = [args.in_features] + [args.llm_hidden] * args.num_mlp_layers
    weights = tuple(
        (torch.randn((dims[i], dims[i + 1]), generator=gen, device=device) * scale)
        .to(args.compute_dtype)
        for i in range(len(dims) - 1)
    )
    biases = tuple(torch.zeros(dims[i + 1], device=device) for i in range(len(dims) - 1))
    return ProjectorParams(weights=weights, biases=biases)
