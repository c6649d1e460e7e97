"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``
(only the tests import both)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_port():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()
    port = ROOT / "src" / "repro_torch"
    for mod in ("axes.py", "launch/mesh.py", "launch/sharding.py",
                "launch/shapes.py", "launch/dryrun.py", "analysis/__init__.py",
                "analysis/__main__.py", "analysis/base.py",
                "analysis/schemes.py", "analysis/rules.py",
                "analysis/carry.py"):
        assert port / mod in FILES, mod
