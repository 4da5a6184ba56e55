"""Import hygiene of the port: ``src/repro_torch/`` and ``chip_smoke.py``
import neither ``jax`` nor anything of the JAX package ``repro``, neither by
an import statement nor by a string handed to ``importlib.import_module`` or
``__import__`` (a plain string, or an f-string whose leading text names the
module, as a config registry builds it)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _leading_text(node: ast.AST):
    """The module name a dynamic-import argument starts with: a string
    constant, or the text before an f-string's first placeholder (None when
    the f-string starts with one, or for any other expression)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr) and node.values:
        first = node.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return first.value
    return None


def _bad_imports(source: str, filename: str = "<src>") -> list:
    tree = ast.parse(source, filename=filename)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            for arg in node.args[:1]:
                text = _leading_text(arg)
                if text is not None and _forbidden(text):
                    bad.append(text)
    return bad


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = _bad_imports(path.read_text(), filename=str(path))
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("source,caught", [
    ("import jax", True),
    ("from repro.models import lm", True),
    ("import importlib\nimportlib.import_module('repro.configs.qwen2_1_5b')", True),
    ("import importlib\narch = 'x'\nimportlib.import_module(f'repro.configs.{arch}')", True),
    ("from importlib import import_module\nimport_module(f'jax.{1}')", True),
    ("__import__(f'jaxlib.{1}')", True),
    ("import importlib\narch = 'x'\nimportlib.import_module(f'repro_torch.configs.{arch}')",
     False),
    ("import importlib\narch = 'x'\nimportlib.import_module(f'.{arch}', __name__)", False),
    ("from ..models.config import ModelConfig", False),
    ("import torch", False),
])
def test_scan_catches_dynamic_imports(source, caught):
    assert bool(_bad_imports(source)) == caught


def test_scan_sees_the_whole_package():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in FILES[:-1]}
    assert {"kernels/flash_attention/ops.py", "models/lm.py", "models/layers.py",
            "configs/__init__.py", "configs/qwen2_1_5b.py", "launch/steps.py",
            "launch/serve.py", "core/engine.py", "obs/__init__.py", "obs/registry.py",
            "obs/telemetry.py", "analysis/recorder.py", "analysis/contracts.py",
            "core/dfw_head.py", "optim/__init__.py", "optim/compression.py",
            "optim/adamw.py", "optim/schedule.py", "optim/hybrid.py", "data/__init__.py",
            "data/pipeline.py", "launch/train.py"} <= names
    assert FILES[-1].name == "chip_smoke.py"
