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


TRAINING_SLICE = [
    "reid_tpu_torch.losses", "reid_tpu_torch.losses.utils",
    "reid_tpu_torch.losses.triplet", "reid_tpu_torch.losses.center",
    "reid_tpu_torch.losses.identification", "reid_tpu_torch.losses.dcc",
    "reid_tpu_torch.losses.xbm", "reid_tpu_torch.losses.hybrid",
    "reid_tpu_torch.train.schedules", "reid_tpu_torch.train.state",
    "reid_tpu_torch.train.steps", "reid_tpu_torch.train.image_train",
    "reid_tpu_torch.data.sampler", "reid_tpu_torch.image_reid_train"]


@pytest.mark.parametrize("mod", TRAINING_SLICE)
def test_training_slice_module_is_checked(mod):
    """The training slice's modules are among those the checks above walk
    (no banned import in their source, each imports with JAX blocked)."""
    assert mod in _modules()
    path = os.path.join(ROOT, *mod.split("."))
    path = path + ".py" if os.path.exists(path + ".py") else os.path.join(
        path, "__init__.py")
    assert not set(_imported_roots(path)) & set(BANNED)


ATTENTION_SLICE = ["reid_tpu_torch.models.triplet_attention",
                   "reid_tpu_torch.models.ema_attention",
                   "reid_tpu_torch.models.layers",
                   "reid_tpu_torch.models.seres18",
                   "reid_tpu_torch.models.factory"]


@pytest.mark.parametrize("mod", ATTENTION_SLICE)
def test_attention_slice_module_is_checked(mod):
    """The SERes18 family's modules (triplet and EMA attention,
    BatchRenorm and the 1-D layers) are among those the checks above walk
    (no banned import in their source, each imports with JAX blocked)."""
    test_training_slice_module_is_checked(mod)


OSNET_SLICE = ["reid_tpu_torch.models.osnet",
               "reid_tpu_torch.models.attention_modules",
               "reid_tpu_torch.train.optim",
               "reid_tpu_torch.train.plr_train",
               "reid_tpu_torch.utils.torch_convert"]


@pytest.mark.parametrize("mod", OSNET_SLICE)
def test_osnet_slice_module_is_checked(mod):
    """OSNet's and PLR-OSNet's modules (the models, their attention,
    MADGRAD, the PLR loop, the converter) are among those the checks above
    walk (no banned import in their source, each imports with JAX
    blocked)."""
    test_training_slice_module_is_checked(mod)


PARALLEL_SLICE = ["reid_tpu_torch.parallel", "reid_tpu_torch.parallel.mesh",
                  "reid_tpu_torch.ops.rerank",
                  "reid_tpu_torch.tracking.streams",
                  "reid_tpu_torch.train.video_train",
                  "reid_tpu_torch.eval.inference",
                  "reid_tpu_torch.models.deeplab",
                  "reid_tpu_torch.data.segmentation"]


@pytest.mark.parametrize("mod", PARALLEL_SLICE)
def test_parallel_slice_module_is_checked(mod):
    """The distributed layer, the modules that take a mesh, DeepLabV3 and
    the segmentation module are among those the checks above walk (no
    banned import in their source, each imports with JAX blocked)."""
    test_training_slice_module_is_checked(mod)


def test_rank_programs_import_no_jax():
    """The gloo ranks of the distributed tests (tests/torch_ranks.py)
    import neither JAX nor the JAX package."""
    path = os.path.join(ROOT, "tests", "torch_ranks.py")
    assert not set(_imported_roots(path)) & set(BANNED)
