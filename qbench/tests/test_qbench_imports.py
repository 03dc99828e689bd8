"""Nothing the benchmark runs imports JAX, flax or the JAX package, compared
by whole top-level module name (`qserve_tpu_torch` starts with
`qserve_tpu` and is allowed); the reference imports nothing of the
program either."""

import ast
import os
import subprocess
import sys
import types

import pytest

from qbench import registry
from qbench.run import FORBIDDEN, forbidden_modules

QB = registry.QBENCH


def _sources():
    for dirpath, _, files in os.walk(QB):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(_imported(p)) & set(FORBIDDEN)) for p in _sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(QB, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            mods = set(_imported(os.path.join(ref, f)))
            assert not mods & {"qserve_tpu_torch", "qserve_tpu", "jax", "jaxlib", "flax"}, f


def test_whole_name_comparison(monkeypatch):
    before = set(forbidden_modules())
    for name in ("qserve_tpu_torch.fake", "jaxtyping", "flaxen", "qserve_tpu_x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "qserve_tpu.engine", types.ModuleType("qserve_tpu.engine"))
    assert set(forbidden_modules()) == before | {"qserve_tpu"}


def test_a_run_loads_no_jax():
    """In a fresh process: the harness, the reference and the port's engine
    path leave jax, flax and the JAX package out of sys.modules."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {registry.ROOT!r})\n"
        "from qbench import run, harness, check, tracing, calibrate\n"
        "from qbench.reference import mistral, mixtral, served\n"
        "from qbench.families import mistral, mixtral\n"
        "import qserve_tpu_torch\n"
        "from qserve_tpu_torch.engine import llm_engine, arg_utils\n"
        "from qserve_tpu_torch.models import llama, mixtral\n"
        "from qserve_tpu_torch.worker import worker\n"
        "print(run.forbidden_modules())\n"
    )
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_entry_refuses_without_the_port(tmp_path):
    """A directory holding only BENCHMARK.json and qbench/: no result, rc != 0."""
    import shutil

    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(QB, tmp_path / "qbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "qbench/run.py", "--workload",
                          "mistral-7b.decode-batch", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["mistral-7b.decode-batch"])
def test_entry_refuses_without_cuda(cell):
    out = subprocess.run([sys.executable, os.path.join(QB, "run.py"), "--workload", cell,
                          "--seed", "1", "--seconds", "1"], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
