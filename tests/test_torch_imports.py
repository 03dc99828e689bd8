"""The port stands alone: importing qserve_tpu_torch (engine and VLM
modules included) loads neither JAX nor the JAX package nor triton,
safetensors, transformers or PIL, and no source file of the port or
chip_smoke.py imports JAX, the JAX package, triton (every kernel is CUDA
C++ built by nvcc) or safetensors (the port reads and writes the format
itself); transformers and PIL are imported only inside a function
(utils/tokenizer.py's get_tokenizer, utils/image_processing.py), and
transformers never by chip_smoke.py: the port needs neither library to
serve token ids or pixel values. The port's scripts (scripts/*_torch.py)
are held to the same rules, and `datasets` (entrypoints/eval_ppl.py's
load_corpus_text) is imported only inside a function too."""

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
# transformers, datasets and PIL: inside a function only (an indented import)
TOP_LEVEL_TRANSFORMERS = re.compile(r"^(?:import|from)\s+(?:transformers|datasets|PIL)\b",
                                    re.M)
ANY_TRANSFORMERS = re.compile(r"^\s*(?:import|from)\s+transformers\b", re.M)
NOT_IMPORTED = ('jax', 'jaxlib', 'qserve_tpu', 'triton', 'safetensors', 'transformers',
                'datasets', 'PIL')
SCRIPTS = ("convert_checkpoint_torch", "eval_tiny_ppl_torch", "deepcompressor_roundtrip_torch",
           "optimize_fidelity")


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
    files += [os.path.join(ROOT, "scripts", f"{n}.py") for n in SCRIPTS]
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
    assert TOP_LEVEL_TRANSFORMERS.search("from PIL import Image")
    assert not TOP_LEVEL_TRANSFORMERS.search("    from PIL import Image")


def test_tensor_parallel_modules_are_scanned():
    """The TP modules are among the modules imported without JAX above and
    the sources scanned (qserve_tpu/parallel and worker/tp_runner.py have
    their counterparts here)."""
    mods = _port_modules()
    for m in ("qserve_tpu_torch.parallel.distributed", "qserve_tpu_torch.parallel.tp",
              "qserve_tpu_torch.parallel.dryrun", "qserve_tpu_torch.worker.tp_runner"):
        assert m in mods
        assert os.path.join(ROOT, *m.split(".")) + ".py" in _sources()


def test_scripts_import_without_jax():
    """The port's scripts import (as modules, main() not run) without JAX,
    the JAX package, triton, safetensors, transformers or datasets."""
    code = (
        "import importlib.util, sys\n"
        f"for n in {SCRIPTS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(n, f'scripts/{n}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{NOT_IMPORTED!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_offline_modules_are_scanned():
    """The offline tooling and the native marshal are among the modules
    imported without JAX and the sources scanned."""
    mods = _port_modules()
    for m in ("qserve_tpu_torch.eval", "qserve_tpu_torch.eval.ppl",
              "qserve_tpu_torch.entrypoints.eval_ppl", "qserve_tpu_torch.quant.optimize",
              "qserve_tpu_torch.native"):
        assert m in mods, m
    srcs = _sources()
    for n in SCRIPTS:
        assert os.path.join(ROOT, "scripts", f"{n}.py") in srcs
    assert TOP_LEVEL_TRANSFORMERS.search("from datasets import load_dataset")
    assert not TOP_LEVEL_TRANSFORMERS.search("    from datasets import load_dataset")
