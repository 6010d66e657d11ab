"""The port imports torch, never jax: an AST scan of every Python file of
``divergen_tpu_torch`` and of ``chip_smoke.py``. From the JAX package only
modules that are jax-free at import may be imported."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALLOWED_FROM_JAX_PACKAGE = {
    "divergen_tpu.modeling.text.tokenizer",
    "divergen_tpu.utils.torch_weights",
}
FILES = sorted((ROOT / "divergen_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "orbax"), (path, mod)
        if top == "divergen_tpu":
            assert mod in ALLOWED_FROM_JAX_PACKAGE, (path, mod)


def test_scan_sees_the_port():
    assert len(FILES) > 10
