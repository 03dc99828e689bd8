"""qserve_tpu_torch: the PyTorch/CUDA port of qserve_tpu for NVIDIA Hopper.

A W4A8KV4 serving engine (continuous batching over a paged 4-bit KV cache)
whose kernels are hand-written for sm_90a in CUDA C++ (kernels/csrc/*.cu,
built by nvcc at first use). Importing the package loads no kernel and no
JAX: kernels build at first use on the card, and CPU tensors take each op's
plain PyTorch version.

Public API as qserve_tpu's: EngineArgs, LLMEngine, SamplingParams.
"""

from qserve_tpu_torch.engine.arg_utils import EngineArgs
from qserve_tpu_torch.engine.llm_engine import LLMEngine
from qserve_tpu_torch.sampling_params import SamplingParams

__version__ = "0.1.0"

__all__ = ["EngineArgs", "LLMEngine", "SamplingParams", "__version__"]
