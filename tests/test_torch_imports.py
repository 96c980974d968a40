"""The port, its chip smoke script and its GPU scripts
(``scripts/torch_*.py``) import neither JAX nor the JAX package
(``repro``); ``repro_torch`` itself is allowed."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_has_modules():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    assert not roots & set(BANNED), f"{path} imports {roots & set(BANNED)}"


def test_the_check_catches_a_banned_import():
    src = "import jax.numpy\nfrom repro.kernels import ops\nimport repro_torch"
    assert set(_imported_roots(ast.parse(src))) == {"jax", "repro",
                                                    "repro_torch"}
