"""PyTorch port: no port module and not chip_smoke.py imports JAX, optax
or the JAX package (an AST walk: a text search would be fooled by the
port's own package name, which extends the JAX package's)."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "autoencoder_based_image_compression_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "autoencoder_based_image_compression_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for (root, _, names) in os.walk(os.path.join(REPO, PORT)):
        files.extend(os.path.join(root, n) for n in names if n.endswith(".py"))
    return sorted(files)


def _imported_modules(path):
    with open(path) as file:
        tree = ast.parse(file.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_never_imports_jax(path):
    for module in _imported_modules(path):
        assert module.split(".")[0] not in FORBIDDEN, f"{path} imports {module}"


def test_walk_sees_the_whole_port():
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    assert "chip_smoke.py" in rel
    assert f"{PORT}/parallel/inference.py" in rel
    assert f"{PORT}/ops/kernels/gdn_kernel.py" in rel
    # The training path.
    for name in ("ops/density.py", "train/state.py", "train/step.py", "train/loop.py",
                 "train/checkpoint.py", "cli/train_eae.py", "cli/collect_stats.py",
                 "coding/stats.py", "utils/parsing.py", "eval/visualization.py"):
        assert f"{PORT}/{name}" in rel
    # The rate-distortion study: ladder trainer, sweep, anchors, datasets.
    for name in ("train/ladder.py", "cli/train_ladder.py", "eval/rd_sweep.py",
                 "cli/reconstruct_kodak.py", "cli/create_datasets.py", "codecs/__init__.py",
                 "codecs/common.py", "codecs/jpeg2000.py", "codecs/hevc.py", "codecs/jpeg.py",
                 "data/kodak.py", "data/bsds.py", "data/imagenet.py", "data/download.py",
                 "ops/metrics.py", "utils/image.py", "coding/native.py",
                 "coding/compression.py"):
        assert f"{PORT}/{name}" in rel
    assert "optax" in FORBIDDEN
    # The walk flags the reference package, and only it, by its top name.
    assert "autoencoder_based_image_compression_tpu.models".split(".")[0] in FORBIDDEN
    assert PORT not in FORBIDDEN
