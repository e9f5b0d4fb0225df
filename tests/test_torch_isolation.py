"""The port `reid_tpu_torch` stands alone: no module of it imports JAX, flax
or the JAX package, and every module imports with those blocked. Nor do
the two files that run on a machine with a card and no JAX: chip_smoke.py
and the card tests."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "reid_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "reid_tpu")


def _modules():
    out = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_banned_import_in_source():
    found = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                found += [(path, r) for r in _imported_roots(path)
                          if r in BANNED]
    assert not found, found
    assert len(_modules()) >= 20


def test_every_module_imports_without_jax():
    code = (
        "import sys, importlib\n"
        + "".join(f"sys.modules[{b!r}] = None\n" for b in BANNED)
        + f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) == len(_modules())


@pytest.mark.parametrize("path", ["chip_smoke.py",
                                  "tests/test_torch_on_card.py"])
def test_chip_smoke_imports_no_jax(path):
    roots = set(_imported_roots(os.path.join(ROOT, path)))
    assert not roots & set(BANNED), roots
