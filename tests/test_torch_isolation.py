"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points never continue silently on the host."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "spark_rapids_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_tpu")


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_reference():
    seen = 0
    for path in _port_sources():
        seen += 1
        bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
    assert seen > 10


def test_import_leaves_jax_out_of_the_process():
    code = ("import sys, spark_rapids_tpu_torch.session, "
            "spark_rapids_tpu_torch.entry, spark_rapids_tpu_torch.functions;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'spark_rapids_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    from spark_rapids_tpu_torch.entry import entry
    from spark_rapids_tpu_torch.session import TorchSession
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSession()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
