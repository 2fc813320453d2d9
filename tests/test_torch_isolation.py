"""The PyTorch port stands alone: no module of dlrover_tpu_torch, and
neither chip_smoke.py nor chip_ab.py, imports JAX, its libraries (flax,
optax, ml_dtypes) or the JAX package (the machine with the card has none
of them installed), nor names a module of the JAX package in a string (a
run-time dependency, such as ``"-m", "dlrover_tpu.trainer.elastic_run"``
in a subprocess command, fails as an import does)."""

import ast
import re
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


# a dotted module name of the JAX package; a path (dlrover_tpu/...) or a
# directory name is not one
MODULE_NAME = re.compile(r"(?<![\w./-])dlrover_tpu(?:\.[A-Za-z_]\w*)+")
# the master's gRPC service name, a string constant of its own: a name on
# the wire that both packages' masters and clients share (the client's
# method paths, "/dlrover_tpu.Master/get", are not matched at all), not a
# module; test_wire_name_is_no_module holds that no module bears it
WIRE_NAMES = ("dlrover_tpu.Master",)


def _named_modules(path: Path):
    """The JAX package's modules that the file's string constants name,
    docstrings, other bare string statements and the wire names aside."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bare = {id(node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Expr)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in bare and node.value not in WIRE_NAMES):
            for match in MODULE_NAME.finditer(node.value):
                yield match.group(0)


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


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_string_names_a_reference_module(path):
    named = list(_named_modules(path))
    assert not named, f"{path.relative_to(ROOT)} names {named}"


def test_string_checker_catches_a_module_run_by_name(tmp_path):
    sample = tmp_path / "sample.py"
    sample.write_text(
        '"""Docstrings may cite dlrover_tpu.parallel.sharding."""\n'
        'cmd = [sys.executable, "-m", "dlrover_tpu.trainer.elastic_run"]\n'
        'line = f"python -m dlrover_tpu.master.main --port {port}"\n'
        'ok = ["dlrover_tpu", "dlrover_tpu/ops/pallas/x.py:1",\n'
        '      "dlrover_tpu_torch.parallel", "dlrover_tpu_ckpt_job_0"]\n'
    )
    assert list(_named_modules(sample)) == [
        "dlrover_tpu.trainer.elastic_run", "dlrover_tpu.master.main"]


def test_wire_name_is_no_module(tmp_path):
    for name in WIRE_NAMES:
        parts = name.split(".")
        assert not (ROOT.joinpath(*parts).with_suffix(".py").exists()
                    or ROOT.joinpath(*parts).exists()), name
    sample = tmp_path / "sample.py"
    sample.write_text(
        'SERVICE_NAME = "dlrover_tpu.Master"\n'
        'cmd = "python -m dlrover_tpu.Master.main"\n'
        'mod = "dlrover_tpu.master.main"\n'
    )
    assert list(_named_modules(sample)) == [
        "dlrover_tpu.Master.main", "dlrover_tpu.master.main"]


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
