"""Nothing ``run.py`` loads is JAX or the JAX package (top-level names
compared whole: ``vqacl_tpu_torch`` is not ``vqacl_tpu``), and the
reference imports nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

from portbench import harness, spec

HERE = os.path.join(spec.ROOT, "portbench")


def test_harness_and_entries_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r);"
            "import portbench.harness as h, portbench.check, "
            "portbench.trace, portbench.entries.cl_train, "
            "portbench.reference.train;"
            "print(','.join(h.forbidden_modules()))" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_forbidden_compares_whole_names(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vqacl_tpu_torch.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(HERE, "reference", "*.py"))
    assert files
    for f in files:
        mods = set(imports(f))
        assert not mods & {"vqacl_tpu_torch", "vqacl_tpu", "jax", "flax"}, f
    # nor through the benchmark modules it uses
    for f in ("weights.py",):
        assert not set(imports(os.path.join(HERE, f))) & {
            "vqacl_tpu_torch", "vqacl_tpu", "jax"}


def test_no_benchmark_file_imports_jax():
    for f in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        assert not set(imports(f)) & {"jax", "jaxlib", "flax", "vqacl_tpu"}, f
