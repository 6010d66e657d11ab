"""The port imports torch, never jax, and nothing of the JAX package: an AST
scan of every Python file of ``divergen_tpu_torch`` and of ``chip_smoke.py``.
OpenCV, PIL and torchvision are banned too: the port decodes, resizes and writes images
with torch and the standard library."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANNED = ("divergen_tpu", "jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "torchvision")
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
        assert mod.split(".")[0] not in BANNED, (path, mod)


def test_scan_sees_the_port():
    assert len(FILES) > 10
    seen = {str(p.relative_to(ROOT / "divergen_tpu_torch")) for p in FILES[:-1]}
    assert {"engine/train_loop.py", "engine/trainer.py", "solver/build.py", "ops/losses.py",
            "structures/masks.py", "predictor.py", "engine/eval_loop.py",
            "engine/checkpoint.py", "evaluation/lvis_evaluator.py", "native/__init__.py",
            "data/dataset_mapper.py", "utils/visualizer.py", "active/bsgal.py", "train_net.py",
            "data/inst_pool.py", "data/copy_paste_mapper.py", "data/loader.py",
            "data/samplers.py", "engine/events.py"} <= seen
