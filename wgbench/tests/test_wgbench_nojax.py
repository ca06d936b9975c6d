"""Nothing the benchmark loads is JAX, flax or the JAX package, compared by
whole top-level names; the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from wgbench import spec
from wgbench.run import forbidden_modules

FORBIDDEN = {"jax", "jaxlib", "flax", "wholegraph_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, names in os.walk(os.path.join(spec.HERE, sub)):
        yield from (os.path.join(d, n) for n in names if n.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert set(_imports(path)) <= {"__future__", "dataclasses", "math", "typing", "torch"}, path


def test_names_are_compared_whole():
    mods = {"wholegraph_tpu_torch": 1, "wholegraph_tpu_torch.ops": 1, "jaxtyping": 1,
            "flaxen": 1, "torch": 1}
    assert forbidden_modules(mods) == []
    assert forbidden_modules({**mods, "wholegraph_tpu.ops": 1, "jax.numpy": 1}) == [
        "jax", "wholegraph_tpu"]


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, tempfile\n"
        "sys.path.insert(0, %r)\n"
        "from wgbench.tests.tiny import tiny_cell\n"
        "from wgbench.run import run_cell, forbidden_modules\n"
        "d = tempfile.mkdtemp()\n"
        "for name in ('sage-products.train', 'sage-products.fullgraph'):\n"
        "    r = run_cell(tiny_cell(d + '/' + name, name), 3, 0.1, True, device='cpu', t0=0.0)\n"
        "    assert r['correct'], r\n"
        "print('FORBIDDEN', forbidden_modules())\n" % spec.root_of())
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "wgbench.run", "--workload",
                          "sage-products.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=spec.root_of(), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(os.path.join(spec.root_of(), "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "wgbench")
    out = subprocess.run([sys.executable, "-m", "wgbench.run", "--workload",
                          "sage-products.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
