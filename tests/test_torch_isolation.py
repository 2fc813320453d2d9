"""The PyTorch port stands alone: no module of dlrover_tpu_torch, and
neither chip_smoke.py nor chip_ab.py, imports JAX, its libraries (flax,
optax, ml_dtypes) or the JAX package (the machine with the card has none
of them installed)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "dlrover_tpu")
FILES = sorted((ROOT / "dlrover_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_ab.py"
]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_each_form(tmp_path):
    sample = tmp_path / "sample.py"
    sample.write_text(
        "import jax.numpy as jnp\n"
        "from dlrover_tpu.common import log\n"
        "from flax import linen\n"
        "x = __import__('optax')\n"
        "import ml_dtypes\n"
        "import importlib\n"
        "y = importlib.import_module('jaxlib')\n"
        "import dlrover_tpu_torch\n"
        "from . import sibling\n"
    )
    found = {m for m in _imported_modules(sample) if _forbidden(m)}
    assert found == {"jax.numpy", "dlrover_tpu.common", "flax", "optax",
                     "ml_dtypes", "jaxlib"}
