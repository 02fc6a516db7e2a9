"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's); the reference loads nothing of the port either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "ghostm_tpu"}
REFERENCE = ("portbench.reference", "portbench.simulate",
             "portbench.longreads", "portbench.check", "portbench.roofline")


def imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_sources_import_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("mod", REFERENCE)
def test_reference_sources_import_nothing_of_the_port(mod):
    path = HERE.parent / (mod.replace(".", "/") + ".py")
    assert not imported(path) & (JAX | {"ghostm_tpu_torch"})


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=HERE.parent, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded("; ".join(f"import {m}" for m in REFERENCE))
    assert not loaded & (JAX | {"ghostm_tpu_torch"})


def test_harness_loads_no_jax():
    code = ("import portbench.run, portbench.trace, portbench.spec\n"
            "from ghostm_tpu_torch import cli, engine, pipeline\n"
            "from ghostm_tpu_torch.index import diskio\n"
            "for m in ('reads_per_s', 'sw_fused_roofline'):\n"
            "    portbench.spec.reader(m)")
    loaded = _loaded(code)
    assert "ghostm_tpu_torch" in loaded and not loaded & JAX


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "ghostm_tpu_torch_x", sys)
    assert run.forbidden_modules() == sorted(
        JAX & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "ghostm_tpu.sub", sys)
    assert "ghostm_tpu" in run.forbidden_modules()
