"""Weight bridge and package isolation of the torch port.

- flax -> state_dict -> flax is exact, and the state_dict loads strictly
  into the port's detector;
- a second path: the port's state_dict, saved as a ``.pth``, reads back
  through the JAX package's own checkpoint importer
  (``dsl_tpu.utils.torch_import``) to the same flax variables, so the
  port's parameter names are the reference checkpoints' names;
- ``import dsl_tpu_torch`` and every module of it (found by walking the
  package) bring in no ``jax``, ``flax`` or ``dsl_tpu`` module, checked in
  a fresh interpreter and by an AST scan of the package and
  ``chip_smoke.py``; the weight bridge (``utils``) loads no module of the
  train layer;
- no module of the port loads Pillow or OpenCV (the card's machine has
  neither): the strong augmentations and the evaluation are torch and
  numpy code, and only the CPU decode route of ``data/image_io.py`` reads
  with OpenCV, inside the function.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import torch_port_util as U
from dsl_tpu.utils.torch_import import load_rla_backbone, load_torch_detector
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
HOST_IMAGE_LIBS = {"PIL", "cv2"}
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dsl_tpu")


@pytest.fixture(scope="module")
def tiny():
    return U.jax_detector_and_variables(U.TINY_CFG, seed=3)[1]


def _assert_trees_equal(got, want):
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert np.shape(g) == np.shape(w), path
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=str(path))


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def test_round_trip_is_exact(tiny):
    sd = flax_to_state_dict(tiny)
    _assert_trees_equal(_sorted(state_dict_to_flax(sd)), _sorted(tiny))


def test_state_dict_matches_the_ports_modules(tiny):
    from dsl_tpu_torch.models import build_detector

    det = build_detector(U.TINY_CFG)
    sd = flax_to_state_dict(tiny)
    assert set(sd) == set(det.state_dict())
    det.load_state_dict(sd, strict=True)
    for k, v in det.state_dict().items():
        assert v.shape == sd[k].shape, k


def _zeros_like(tree):
    return jax.tree_util.tree_map(np.zeros_like, tree)


def test_backbone_reads_back_through_torch_import(tiny):
    port = U.port_detector(U.TINY_CFG, tiny)
    sd = {k: v.numpy() for k, v in port.state_dict().items()
          if k.startswith("backbone.")}
    got = load_rla_backbone(sd, _zeros_like(tiny))
    for coll in ("params", "batch_stats"):
        _assert_trees_equal(_sorted(got[coll]["backbone"]),
                            _sorted(tiny[coll]["backbone"]))


def test_detector_reads_back_through_torch_import(tiny, tmp_path):
    port = U.port_detector(U.TINY_CFG, tiny)
    path = tmp_path / "port.pth"
    torch.save(port.state_dict(), path)
    got = load_torch_detector(str(path), _zeros_like(tiny))
    _assert_trees_equal(_sorted(got), _sorted(tiny))


def test_import_brings_in_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import dsl_tpu_torch.utils.jax_bridge, dsl_tpu_torch.utils.random_weights\n"
        "utils = sorted(set(sys.modules) - before)\n"
        "import importlib, pkgutil, dsl_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    dsl_tpu_torch.__path__, 'dsl_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import json\n"
        "print(json.dumps(names))\n"
        "print(json.dumps(utils))\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    names, utils, added = map(json.loads, out.stdout.strip().splitlines()[-3:])
    files = sorted((REPO / "dsl_tpu_torch").rglob("*.py"))
    assert len(names) + 1 == len(files) > 40     # the root package aside
    for module in ("data.image_io", "data.loader", "train.semi",
                   "train.runner", "apis.train", "utils.checkpoint",
                   "data.pipelines.image_ops", "data.pipelines.strong_aug",
                   "apis.test", "core.eval.coco_eval"):
        assert f"dsl_tpu_torch.{module}" in names
    # the weight bridge is a leaf below the train layer
    assert not [m for m in utils if m.startswith("dsl_tpu_torch.train")]
    assert any(m.startswith("dsl_tpu_torch") for m in added)
    bad = [m for m in added if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert not [m for m in added if m.split(".")[0] in HOST_IMAGE_LIBS]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_import_in_the_port_sources():
    files = sorted((REPO / "dsl_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        bad = [m for m in _imported_roots(f) if m in FORBIDDEN]
        assert not bad, (f, bad)
        libs = [m for m in _imported_roots(f) if m in HOST_IMAGE_LIBS]
        assert not libs or f.name == "image_io.py", (f, libs)
