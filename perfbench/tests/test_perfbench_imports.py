"""Nothing the benchmark runs loads JAX or the JAX package (whole
top-level names: the port's name begins with the JAX package's), and the
reference loads nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench import core

HERE = core.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "badger_amcl_tpu"}
HARNESS = ["perfbench.run", "perfbench.core", "perfbench.control", "perfbench.trace",
           "perfbench.peaks", "perfbench.drivers.node", "perfbench.gen.store",
           "perfbench.gen.route", "perfbench.gen.raycast", "perfbench.reference.amcl",
           "perfbench.reference.check"]


def _loaded_after(modules) -> set:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "import badger_amcl_tpu_torch.node, badger_amcl_tpu_torch.mcl\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    env = dict(os.environ, PYTHONPATH=core.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=core.ROOT, timeout=300, check=True)
    return set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax():
    loaded = _loaded_after(HARNESS)
    assert "badger_amcl_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_forbidden_names_compare_whole(monkeypatch):
    import types

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "badger_amcl_tpu_torch_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib_like", types.ModuleType("x"))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "badger_amcl_tpu.maps", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert core.forbidden_modules() == ["badger_amcl_tpu", "jax"]


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(os.path.join(HERE, "reference"))
                                        if f.endswith(".py")))
def test_reference_imports_nothing_of_the_program(name):
    tops = {n.split(".")[0] for n in _imports(os.path.join(HERE, "reference", name))}
    assert not tops & (FORBIDDEN | {"badger_amcl_tpu_torch"}), tops


def test_reference_loads_nothing_of_the_program():
    code = ("import json, sys\nimport perfbench.reference.check\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=core.ROOT), cwd=core.ROOT,
                         timeout=300, check=True)
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"badger_amcl_tpu_torch"})
