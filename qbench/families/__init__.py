"""Model families: everything the harness knows of a model, one module a
`model_type`, qbench/families/<model_type>.py, loaded by path from the
configuration file's `model_type` (qbench/registry.py `family_of`). A new
architecture comes as new files: its configuration, its family module and
its reference (qbench/reference/<model_type>.py), and edits none.

A family module supplies:

  * `sizes(cfg)`: the widths under the harness's names (qbench/weights.py
    `Sizes` and the family's own, such as a window per layer or the
    experts' count and width);
  * `float_params(maker)`: the float weights, drawn through the maker's
    seeded tags, in the layout its `quantize_params` reads;
  * `program(cfg)`: a `Program`, what the port serves the model with;
  * `Reference(maker, act_bits=None)`: the plain f32 reference, with
    `served_logits(seqs)` (qbench/reference/);
  * `step_ops(step, sz)`, `gemm_bound_s(step, sz)`,
    `paged_attn_bound_s(step, sz)`: one step's operations (mfu) and its
    least time in the W4A8 GEMMs and in K4 (the rooflines), from the
    building blocks in qbench/roofline/.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class Program:
    args: object  # the port's LlamaArgs
    quantize: Callable  # quantize_params(float_params, args, device=...)
    cache: dict  # the CacheConfig fields the model fixes


def quant_spec(cfg: dict):
    """The port's QuantSpec of the configuration's `serving` precision."""
    from qserve_tpu_torch.config import QuantSpec

    s = cfg["serving"]
    return QuantSpec.from_precision(s["precision"], s["group_size"], s["kv_zero_point"],
                                    lm_head_bits=s["lm_head_bits"])
