"""What a run loads: no module whose top-level name (the part before the
first dot, compared whole) is JAX's or the JAX package's, and nothing of
the program in the reference."""

import ast
import json
import os
import subprocess
import sys

from gcbench import harness
from gcbench.tests import tiny

REF = os.path.join(tiny.REPO, "gcbench", "reference")


def test_a_run_loads_nothing_of_jax(tiny_root):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from gcbench.tests import tiny\n"
        "from gcbench import harness, control\n"
        "tiny.run(%r, 'tiny_city.frame', seed=5, trace=True)\n"
        "tiny.run(%r, 'tiny_bldg.train', seed=5)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    ) % (tiny.REPO, tiny_root, tiny_root)
    out = subprocess.run([sys.executable, "-c", "import json\n" + code],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=tiny.REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in mods}
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)
    assert "gaussiancity_tpu_torch" in tops  # the program under test


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gaussiancity_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program_or_jax():
    bad = set(harness.FORBIDDEN) | {"gaussiancity_tpu_torch"}
    seen = 0
    for d, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                seen += 1
                for mod in _imports(os.path.join(d, f)):
                    assert mod.split(".")[0] not in bad, (f, mod)
    assert seen > 20
