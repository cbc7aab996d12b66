"""The PyTorch port imports neither JAX nor the JAX package.

An AST scan of every module of k8s_llm_monitor_tpu_torch/ and of
chip_smoke.py: any ``import jax``/``from jax`` (or a jax submodule) and any
import of ``k8s_llm_monitor_tpu`` fails the test.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "k8s_llm_monitor_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "k8s_llm_monitor_tpu")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_files_found():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\n"
                 "from k8s_llm_monitor_tpu.models import llama\n"
                 "import k8s_llm_monitor_tpu_torch\n")
    assert [n for n in _imports(f) if _forbidden(n)] == [
        "jax.numpy", "k8s_llm_monitor_tpu.models"]
