"""The benchmark loads neither JAX nor the JAX package, and its plain
reference imports nothing of the program under test.  Modules are
compared by their whole top-level name (the part before the first dot):
the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

FORBIDDEN = {"jax", "jaxlib", "flax", "grad_traj_optimization_tpu"}
PROGRAM = "grad_traj_optimization_torch"

DRIVE = r"""
import json, os, sys
sys.path[:0] = [{root!r}, {here!r}]
import tiny, tempfile
from gtop_bench import spec, run
import gtop_bench.check, gtop_bench.roofline, gtop_bench.trace, gtop_bench.traffic
r = tiny.make_root(tempfile.mkdtemp())
for w in spec.benchmark(r)["workloads"]:
    run.run_cell(spec.cell(w["name"], r), 3, 0.3, True, "cpu")
for m in spec.benchmark(r)["per_layer"]:
    spec.reader(m["name"], r)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_benchmark_loads_no_jax():
    p = subprocess.run([sys.executable, "-c", DRIVE.format(root=ROOT, here=HERE)],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(__import__("json").loads(p.stdout.strip().splitlines()[-1]))
    assert PROGRAM in loaded  # the run did drive the program
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_and_reference_no_program():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
            if os.path.basename(dirpath) == "reference":
                assert PROGRAM not in tops, path
