"""The port stands alone: no file of ``src/repro_torch/``, not
``chip_smoke.py`` and no ``examples/*_torch.py`` imports ``jax`` or the
reference package, and importing every port module leaves ``jax`` out of
``sys.modules``."""

import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "examples").glob("*_torch.py"))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def _modules():
    return sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_no_port_file_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 10
    bad = [f"{p.relative_to(ROOT)}:{line}: {root}"
           for p in files for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_importing_every_port_module_leaves_jax_out(monkeypatch):
    modules = _modules()
    for required in ("repro_torch.serve.tnn_engine",
                     "repro_torch.models.ssm",
                     "repro_torch.models.transformer",
                     "repro_torch.serve.engine",
                     "repro_torch.kernels.ssd_scan",
                     "repro_torch.models.attention",
                     "repro_torch.models.moe",
                     "repro_torch.kernels.moe_gate",
                     "repro_torch.data.pipeline",
                     "repro_torch.optim.optimizers",
                     "repro_torch.optim.grad_compression",
                     "repro_torch.train.train_loop",
                     "repro_torch.launch.train",
                     "repro_torch.launch.dryrun",
                     "repro_torch.launch.input_specs",
                     "repro_torch.launch.mesh",
                     "repro_torch.roofline.analysis",
                     "repro_torch.roofline.op_cost",
                     "repro_torch.sharding.specs",
                     "repro_torch.kernels.rnl_shard"):
        assert required in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
