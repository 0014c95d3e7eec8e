"""Nothing the harness loads is JAX or the JAX package, compared by whole
top-level module names (the port's package name begins with the JAX
package's), and the reference loads nothing of the port."""
import ast
import os
import subprocess
import sys

from meshbench.harness import FORBIDDEN
from meshbench.registry import PACKAGE_DIR, ROOT

_ALL = """
import sys, time
from meshbench.tests.tiny import make_root
from meshbench.registry import Registry
from meshbench.harness import make_cell, run_cell
import meshbench.run, meshbench.calibrate
import meshbench.drivers.train_epochs
root = make_root(sys.argv[1])
reg = Registry(root)
for m in reg.bench["per_layer"]:
    reg.metric_reader(m["name"])
run_cell(reg, make_cell(reg, "grid.train", 3, 0.2, False, "cpu",
                        time.perf_counter()))
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = """
import sys
import meshbench.reference.model, meshbench.reference.mesh
import meshbench.reference.native, meshbench.judge
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split("\n")[-2].split())


def test_a_run_loads_no_jax(tmp_path):
    names = _top_level(_ALL, str(tmp_path))
    assert "meshvae_tpu_torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level(_REFERENCE)
    assert not names & ({"meshvae_tpu_torch"} | set(FORBIDDEN))


def test_no_source_file_imports_jax_or_the_program_in_the_reference():
    for dirpath, _, files in os.walk(PACKAGE_DIR):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as fp:
                tree = ast.parse(fp.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                else:
                    continue
                tops = {m.split(".")[0] for m in mods}
                assert not tops & set(FORBIDDEN), (path, tops)
                if os.sep + "reference" in dirpath:
                    assert "meshvae_tpu_torch" not in tops, path
