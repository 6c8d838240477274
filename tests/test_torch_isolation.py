"""repro_torch and chip_smoke.py import neither jax nor the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test process has both; the port must not need it)
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == \
                "import_module" and node.args and \
                isinstance(node.args[0], (ast.Constant, ast.JoinedStr)):
            first = node.args[0]
            text = first.value if isinstance(first, ast.Constant) else \
                "".join(v.value for v in first.values
                        if isinstance(v, ast.Constant))
            roots.add(text.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    assert path.exists(), path
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_serve_path_loads_without_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.checkpoint.bridge;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'));"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)
