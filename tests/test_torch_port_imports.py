"""The PyTorch port imports nothing of JAX or of the JAX package.

Checked in a fresh interpreter (this test session has jax loaded by
conftest.py) and by an AST scan of every source file of the port."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "multimodal_outage_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "chex", "multimodal_outage_tpu")


def _port_modules():
    import multimodal_outage_tpu_torch as pkg

    names = ["multimodal_outage_tpu_torch"]
    for info in pkgutil.walk_packages(pkg.__path__, "multimodal_outage_tpu_torch."):
        if info.name != "multimodal_outage_tpu_torch.__main__":
            names.append(info.name)
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax_in_fresh_interpreter():
    mods = _port_modules()
    assert "multimodal_outage_tpu_torch.serving" in mods
    assert "multimodal_outage_tpu_torch.ops.double_conv" in mods
    for m in ("ops.max_pool", "models.layers", "models.unet", "models.fusion",
              "train.state", "train.steps", "train.loop", "core.checkpoint",
              "core.run_logging", "ops.gwnet_layer", "ops.dcrnn_stack", "models.dcrnn",
              "data.stats", "viz.maps", "train.date2vec_pretrain"):
        assert f"multimodal_outage_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, f"port pulled in {bad}"


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize(
    "path", sorted(os.path.relpath(p, REPO) for p in _sources())
)
def test_port_source_has_no_jax_import(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_chip_smoke_has_no_jax_import():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = (
                [a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""]
            )
            assert not [n for n in names if _forbidden(n)], node.lineno
