"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port (top-level names compared whole)."""

import ast
import os
import subprocess
import sys

from codec_bench import harness


def _imports(path):
    with open(path) as file:
        tree = ast.parse(file.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(folder):
    for (directory, _, files) in os.walk(folder):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(directory, name)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(harness.BENCH_DIR):
        assert not _imports(path) & set(harness.FORBIDDEN_MODULES), path


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(harness.BENCH_DIR, "reference")):
        assert _imports(path) <= {"math", "os", "pickle", "numpy", "torch", "codec_bench"}, path


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["autoencoder_based_image_compression_tpu_torch.models",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "autoencoder_based_image_compression_tpu.x"]
                                     ) == ["autoencoder_based_image_compression_tpu", "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = (
        "import sys, time\n"
        "from codec_bench import harness, run\n"
        "from codec_bench.tests import helpers\n"
        f"registry = helpers.tiny_checkout({str(tmp_path)!r})\n"
        "for cell in ('eae_learned_bw.serve', 'eae_fixed_bw.ladder_train'):\n"
        "    run.execute(registry, cell, 5, 0.3, 0, 'cpu', time.time())\n"
        "print(harness.forbidden_modules())\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"
