"""PyTorch port: no port module, nor chip_smoke.py, bench_torch.py or the
two-process tests' worker, imports JAX, optax or the JAX package (an AST
walk: a text search would be fooled by the port's own package name, which
extends the JAX package's)."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "autoencoder_based_image_compression_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "autoencoder_based_image_compression_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "bench_torch.py"),
             os.path.join(REPO, "tests", "torch_distributed_worker.py")]
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
    # The rest of serving and the port's bench, throughput and roofline tools.
    assert "bench_torch.py" in rel
    for name in ("engine/quantized.py", "parallel/continuous_batching.py",
                 "eval/throughput.py", "eval/roofline.py", "eval/gate_probe.py",
                 "eval/serving_bench.py", "eval/workload.py", "cli/benchmark.py"):
        assert f"{PORT}/{name}" in rel
    # The distributed layer.
    for name in ("parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py",
                 "parallel/sharding.py", "parallel/train_parallel.py", "parallel/spatial.py",
                 "dryrun.py"):
        assert f"{PORT}/{name}" in rel
    # The SVHN side and the latent-analysis tooling.
    for name in ("data/svhn.py", "models/dense_eae.py", "models/vae.py", "ops/gradcheck.py",
                 "cli/train_svhn.py", "cli/overfit_svhn.py", "cli/reconstruct_svhn.py",
                 "cli/compare_entropy_approximations.py", "cli/train_vae.py",
                 "eval/analysis.py", "cli/latent_analysis.py", "cli/visualize_model.py",
                 "utils/import_reference.py"):
        assert f"{PORT}/{name}" in rel
    # The campaign scripts and the reference-parity harness.
    for name in ("scripts/__init__.py", "scripts/rd_campaign.py", "scripts/stability_study.py",
                 "scripts/resilient_campaign.py", "eval/reference_parity.py"):
        assert f"{PORT}/{name}" in rel
    assert "optax" in FORBIDDEN
    # The walk flags the reference package, and only it, by its top name.
    assert "autoencoder_based_image_compression_tpu.models".split(".")[0] in FORBIDDEN
    assert PORT not in FORBIDDEN


def test_reference_parity_imports_tensorflow_only_inside_its_functions():
    path = os.path.join(REPO, PORT, "eval", "reference_parity.py")
    with open(path) as file:
        tree = ast.parse(file.read(), filename=path)
    top = [node for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))]
    assert top and not any(name.split(".")[0] == "tensorflow" for node in top
                           for name in ([alias.name for alias in node.names]
                                        if isinstance(node, ast.Import) else [node.module]))
    inside = {name for function in tree.body if isinstance(function, ast.FunctionDef)
              for node in ast.walk(function) if isinstance(node, ast.Import)
              for name in (alias.name for alias in node.names)}
    assert "tensorflow" in inside
