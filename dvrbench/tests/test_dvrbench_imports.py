"""Nothing a run loads is JAX or the JAX package (by whole top-level
name: ``differender_tpu_torch`` is not ``differender_tpu``), and the
reference loads nothing of the program."""
import ast
import os
import subprocess
import sys

from conftest import ROOT

RUN = """
import sys, json
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from dvrbench import harness, run
r = run.run_cell("viewer.dense_sim", 5, 0.2, False, "cpu",
                 overrides=harness.small(harness.job_of("viewer.dense_sim")))
print(json.dumps([r["correct"], run.forbidden_modules(),
                  sorted(m for m in sys.modules if m.split(".")[0]
                         in ("jax", "jaxlib", "flax", "differender_tpu"))]))
"""

REF = """
import sys, json
sys.path.insert(0, {root!r})
import dvrbench.reference.fit, dvrbench.reference.dvr
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0].startswith("differender"))))
"""


def _python(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    assert _python(RUN) == '[true, [], []]'


def test_the_reference_loads_nothing_of_the_program():
    assert _python(REF) == "[]"


def test_the_check_compares_whole_top_level_names():
    from dvrbench import run
    assert run.forbidden_modules(["differender_tpu_torch.render",
                                  "differender_tpu_torchx", "numpy"]) == []
    assert run.forbidden_modules(["differender_tpu.render", "jaxlib.xla",
                                  "flax", "jax"]) == [
        "differender_tpu", "flax", "jax", "jaxlib"]


def test_reference_sources_import_no_program():
    ref = os.path.join(ROOT, "dvrbench", "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "differender_tpu", "differender_tpu_torch", "jax"), (f, n)
