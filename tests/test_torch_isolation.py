"""ghostm_tpu_torch imports neither jax nor anything of ghostm_tpu: every
module of the port imports in a subprocess whose import system refuses
both; and chip_smoke.py, which drives the port on the card, names neither
in any import statement."""

import ast
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")

PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "ghostm_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import ghostm_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ghostm_tpu_torch.__path__,
                                              "ghostm_tpu_torch.")
        if m.name != "ghostm_tpu_torch.__main__"]
for m in mods:
    importlib.import_module(m)
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print(len(mods))
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20   # every module was imported


def test_chip_smoke_imports_neither_jax_nor_reference():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "ghostm_tpu_torch.engine" in names   # the walk saw the imports
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "ghostm_tpu")]
    assert not bad, bad
