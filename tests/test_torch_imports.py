"""The port stands alone: importing qserve_tpu_torch (engine included)
loads neither JAX nor the JAX package nor triton, safetensors or
transformers, and no source file of the port or chip_smoke.py imports JAX,
the JAX package, triton (every kernel is CUDA C++ built by nvcc) or
safetensors (the port reads and writes the format itself); transformers is
imported only inside a function (utils/tokenizer.py's get_tokenizer), never
by chip_smoke.py: the port needs neither library to serve token ids."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "qserve_tpu_torch")

# `qserve_tpu_torch` starts with `qserve_tpu`: match the JAX package only
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|triton\b|safetensors\b|qserve_tpu(?!_torch)\b)",
    re.M,
)
# transformers: inside a function only (an indented import)
TOP_LEVEL_TRANSFORMERS = re.compile(r"^(?:import|from)\s+transformers\b", re.M)
ANY_TRANSFORMERS = re.compile(r"^\s*(?:import|from)\s+transformers\b", re.M)
NOT_IMPORTED = ('jax', 'jaxlib', 'qserve_tpu', 'triton', 'safetensors', 'transformers')


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith("__init__") else mod)
    return sorted(mods)


def test_import_leaves_jax_out():
    """Subprocess: tests/conftest.py has already imported JAX here."""
    code = (
        "import sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{NOT_IMPORTED!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    with open(path) as f:
        src = f.read()
    hits = FORBIDDEN.findall(src) + TOP_LEVEL_TRANSFORMERS.findall(src)
    if path.endswith("chip_smoke.py"):
        hits += ANY_TRANSFORMERS.findall(src)
    assert not hits, hits


def test_package_root_exports():
    """`from qserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams,
    __version__` works, as from qserve_tpu, and leaves JAX, the JAX package
    and triton out (subprocess: tests/conftest.py has imported JAX here)."""
    code = (
        "import sys\n"
        "from qserve_tpu_torch import EngineArgs, LLMEngine, SamplingParams, __version__\n"
        "import qserve_tpu_torch\n"
        "assert qserve_tpu_torch.__all__ == ['EngineArgs', 'LLMEngine', "
        "'SamplingParams', '__version__']\n"
        "assert EngineArgs().precision == 'w4a8kv4' and SamplingParams().n == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'qserve_tpu', 'triton'))\n"
        "assert not bad, bad\n"
        "print('ok', __version__)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok 0.1.0")


def test_scan_pattern():
    assert FORBIDDEN.search("from qserve_tpu.kernels import ops")
    assert FORBIDDEN.search("    import jax.numpy as jnp")
    assert FORBIDDEN.search("    import triton.language as tl")
    assert not FORBIDDEN.search("from qserve_tpu_torch.kernels import ops")
    assert FORBIDDEN.search("    from safetensors.numpy import load_file")
    assert TOP_LEVEL_TRANSFORMERS.search("from transformers import AutoTokenizer")
    assert not TOP_LEVEL_TRANSFORMERS.search("    from transformers import AutoTokenizer")
