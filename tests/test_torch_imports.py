"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_banned_imports(tmp_path):
    """The scanner itself: each banned spelling is caught, the port's own
    package name is not."""
    src = tmp_path / "m.py"
    for line, banned in (("import jax", True),
                         ("import jax.numpy as jnp", True),
                         ("from jax import lax", True),
                         ("from repro.streams import engine", True),
                         ("import repro.core.chaos", True),
                         ("from repro_torch.streams import engine", False),
                         ("import numpy as np", False)):
        src.write_text(line + "\n")
        assert any(_banned(m) for m in _imports(src)) == banned, line
