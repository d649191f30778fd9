"""Weights into the port, against the JAX package, on the CPU.

- the mmdet-parity ``ResNet`` (depth 50, caffe and pytorch styles, full
  width) against the flax module's forward on the same weights (the
  features within 1e-4 of their largest magnitude: sums over thousands of
  products in another order), its frozen set against the JAX optimizer's
  mask, and its unported options refused;
- ``utils/torch_import``: ``.pth`` files in the RLA ImageNet layout, the
  mmdet/torchvision ResNet layout (backbones) and the mmdet detector
  layout, written from seeded weights, load into the port to exactly the
  tensors ``dsl_tpu.utils.torch_import.load_torch_backbone`` /
  ``load_torch_detector`` load into flax (compared through the weight
  bridge), every key of the port's module found;
- ``train_detector`` loads a ``pretrained`` backbone and then
  ``load_from`` as ``dsl_tpu.apis.train._maybe_load_pretrained`` does;
- ``init_detector(checkpoint=)`` serves a ``save_weights`` file, a train
  checkpoint's EMA teacher (with the student's buffers) and an mmdet
  ``.pth``; a load that fails raises;
- ``tools/jax_checkpoint_to_torch.py`` turns a JAX ``TrainState`` saved by
  ``dsl_tpu.utils.checkpoint.save_checkpoint`` (orbax and npz) into a port
  checkpoint whose state crosses back to the same tree.
"""

import copy
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from dsl_tpu.apis.train import _maybe_load_pretrained
from dsl_tpu.models.backbones.resnet import ResNet as JaxResNet
from dsl_tpu.train import build_optimizer_from_cfg as j_build_optimizer
from dsl_tpu.train import create_train_state as j_create_train_state
from dsl_tpu.train import frozen_backbone_mask as j_frozen_mask
from dsl_tpu.utils import checkpoint as j_checkpoint
from dsl_tpu.utils import torch_import as j_import
from dsl_tpu_torch.apis import init_detector
from dsl_tpu_torch.apis.train import train_detector
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.models import build_detector, detector_predict
from dsl_tpu_torch.models.backbones.resnet import ResNet
from dsl_tpu_torch.train import build_optimizer_from_cfg, create_train_state
from dsl_tpu_torch.train.bridge import train_state_to_jax
from dsl_tpu_torch.utils import synthetic_data
from dsl_tpu_torch.utils.checkpoint import (
    load_checkpoint, load_weights, save_checkpoint, save_weights)
from dsl_tpu_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax
from dsl_tpu_torch.utils.torch_import import (
    load_torch_backbone, load_torch_detector)
from torch_port_make_fixtures import FIXTURES, OUT

torch.set_num_threads(2)

CFGS = {"rla": U.TINY_CFG, "resnet": U.TINY_BASELINE_CFG}
BACKBONE_TYPE = {"rla": "RLA_ResNet", "resnet": "ResNet"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(got: dict, want: dict):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


def _port_tree(det) -> dict:
    return state_dict_to_flax(det.state_dict())


@pytest.mark.parametrize("style", ["caffe", "pytorch"])
def test_resnet50_matches_jax(style):
    kw = dict(depth=50, style=style, frozen_stages=1)
    jax_mod = JaxResNet(**kw)
    x = U.images(0, 1, (64, 64))
    shapes = jax.eval_shape(jax_mod.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    variables = U.fill_variables(U._plain(shapes), 0)
    want = jax.jit(jax_mod.apply)(variables, x)
    port = ResNet(**kw)
    port.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = port(U.nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(U.nhwc(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    # the frozen set (requires_grad) is the JAX optimizer's mask
    flags = {n: torch.full_like(p, float(not p.requires_grad))
             for n, p in port.named_parameters()}
    got_mask = {k: bool(v.all()) for k, v in _leaves(state_dict_to_flax(
        {f"backbone.{n}": f for n, f in flags.items()})["params"])}
    want_mask = dict(_leaves(j_frozen_mask(
        {"backbone": variables["params"]}, 1)))
    assert got_mask == {k: bool(v) for k, v in want_mask.items()}
    assert any(got_mask.values()) and not all(got_mask.values())


_DCN_STAGES = (False, True, True, True)


@pytest.mark.parametrize("option", [
    dict(dcn=dict(type="DCN"), stage_with_dcn=_DCN_STAGES, depth=18),
    dict(dcn=dict(type="DCNv2", deform_groups=4), stage_with_dcn=_DCN_STAGES,
         depth=34),
    dict(plugins=[dict(cfg=dict(type="GeneralizedAttention"),
                       position="after_conv1")]),
    dict(conv_cfg=dict(type="DCNv2")),
    dict(dcn=dict(type="DCNv3"), stage_with_dcn=_DCN_STAGES),
    dict(plugins=[dict(cfg=dict(type="ContextBlock"))], depth=18)])
def test_resnet_refuses_unported_options(option):
    # (V1d's deep_stem / avg_down and ResNeXt's groups / base_width are
    # ported: tests/test_torch_port_variants.py; deformable convs on a
    # bottleneck too: tests/test_torch_port_dcn.py, and the plugins on a
    # bottleneck: tests/test_torch_port_plugins.py. What stays refused is
    # DCN or a plugin on a BasicBlock, as in the JAX package, a plugin at
    # a position the JAX package never runs, and a DCN type other than
    # mmcv's DCN and DCNv2)
    option = dict(option)
    depth = option.pop("depth", 50)
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        ResNet(depth=depth, **option)


def _seeded(kind, seed):
    """(JAX detector, flax variables, port detector) of the tiny config."""
    det, variables = U.jax_detector_and_variables(CFGS[kind], seed=seed)
    return det, variables, U.port_detector(CFGS[kind], variables)


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_backbone_file_loads_as_jax(kind, tmp_path):
    """The backbone checkpoint as the reference's ImageNet / mmdet
    pretrained files hold it (no prefix), with a classifier and BN counters
    the detector has no place for."""
    _, _, source = _seeded(kind, 1)
    det_j, start, port = _seeded(kind, 2)
    sd = dict(source.backbone.state_dict())
    extras = {"fc.weight": torch.randn(10, 4), "fc.bias": torch.randn(10),
              "bn1.num_batches_tracked": torch.tensor(7)}
    path = tmp_path / "backbone.pth"
    torch.save({"state_dict": {**sd, **extras}}, path)
    want = j_import.load_torch_backbone(str(path), start, BACKBONE_TYPE[kind])
    missing, unexpected = load_torch_backbone(str(path), port.backbone)
    assert missing == [] and sorted(unexpected) == sorted(extras)
    _assert_trees_equal(_port_tree(port), want)
    # and it replaced every backbone weight of the start
    for name, t in port.backbone.state_dict().items():
        assert torch.equal(t, sd[name]), name


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_detector_file_loads_as_jax(kind, tmp_path):
    """A whole detector in mmdet's checkpoint layout (``state_dict`` beside
    ``meta``), as ``load_from`` and ``init_detector`` read it."""
    _, _, source = _seeded(kind, 1)
    _, start, port = _seeded(kind, 2)
    path = tmp_path / "detector.pth"
    torch.save({"meta": {"epoch": 12, "CLASSES": ["a", "b"]},
                "state_dict": source.state_dict()}, path)
    want = j_import.load_torch_detector(str(path), start)
    missing, unexpected = load_torch_detector(str(path), port)
    assert missing == [] and unexpected == []
    _assert_trees_equal(_port_tree(port), want)
    _assert_trees_equal(_port_tree(port), _port_tree(source))
    served = init_detector(Config(dict(model=CFGS[kind])),
                           checkpoint=str(path), device="cpu")
    _assert_trees_equal(_port_tree(served.detector), _port_tree(source))


@pytest.fixture(scope="module")
def semicoco(tmp_path_factory):
    root = tmp_path_factory.mktemp("semicoco")
    sources = [(str(OUT / f"{n}.jpg"), h, w)
               for n, (h, w, _) in FIXTURES.items()]
    return synthetic_data.make_semicoco_dir(root, sources, 2, 2, n_val=2)


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_train_detector_loads_pretrained_then_load_from_as_jax(
        kind, semicoco, tmp_path):
    """``pretrained`` (a backbone file) and ``load_from`` (a neck and head
    file with no backbone keys): the JAX package's loader on flax variables
    and the port's ``train_detector`` (0 epochs) give the same weights."""
    _, _, bb_source = _seeded(kind, 1)
    _, _, rest_source = _seeded(kind, 3)
    bb_path, rest_path = tmp_path / "bb.pth", tmp_path / "rest.pth"
    torch.save(bb_source.backbone.state_dict(), bb_path)
    torch.save({k: v for k, v in rest_source.state_dict().items()
                if not k.startswith("backbone.")}, rest_path)
    model = copy.deepcopy(CFGS[kind])
    model["backbone"]["pretrained"] = str(bb_path)
    cfg = Config(dict(model=model, load_from=str(rest_path),
                      runner=dict(max_epochs=0), optimizer=U.OPTIMIZER,
                      optimizer_config=U.OPTIMIZER_CONFIG,
                      lr_config=U.LR_CONFIG, canvas_hw=(64, 96),
                      data=dict(samples_per_gpu=2,
                                train=_train_split(semicoco))))
    det_j, start = U.jax_detector_and_variables(CFGS[kind], seed=2)
    want = _maybe_load_pretrained(cfg, det_j, start, logging.getLogger())
    runner = train_detector(cfg, str(tmp_path / "work"), device="cpu")
    _assert_trees_equal(_port_tree(runner.state.student), want)
    for name, t in runner.state.student.state_dict().items():
        src = bb_source if name.startswith("backbone.") else rest_source
        assert torch.equal(t, src.state_dict()[name]), name


def _train_split(paths):
    return dict(type="SemiCOCODataset", ann_file=paths["labeled"],
                ann_path=paths["label_store"],
                labelmapper=paths["category_info"], img_prefix=paths["images"],
                pipeline=[dict(type="LoadImageFromFile"),
                          dict(type="LoadAnnotations", with_bbox=True),
                          dict(type="Resize", img_scale=(96, 64),
                               keep_ratio=True),
                          dict(type="Normalize", mean=[123.675, 116.28,
                                                       103.53],
                               std=[58.395, 57.12, 57.375], to_rgb=True),
                          dict(type="Pad", size_divisor=32)])


def _predict(det):
    images = U.nchw(U.images(5, 2, (64, 96)))
    shapes = torch.tensor([[64.0, 96.0]] * 2)
    sfs = torch.ones(2, 4)
    return detector_predict(det, images, img_shapes=shapes, scale_factors=sfs,
                            test_cfg=U.TINY_CFG["test_cfg"], device="cpu")


def test_init_detector_serves_a_weights_file(tmp_path):
    _, _, port = _seeded("rla", 1)
    save_weights(str(tmp_path / "w.pth"), port)
    bundle = init_detector(Config(dict(model=U.TINY_CFG)),
                           checkpoint=str(tmp_path / "w.pth"), device="cpu")
    _assert_trees_equal(_port_tree(bundle.detector), _port_tree(port))
    for got, want in zip(_predict(bundle.detector), _predict(port)):
        assert torch.equal(got, want)


def test_init_detector_serves_a_train_checkpoints_teacher(tmp_path):
    _, _, port = _seeded("rla", 1)
    tx, _ = build_optimizer_from_cfg(U.OPTIMIZER, U.OPTIMIZER_CONFIG,
                                     U.LR_CONFIG)
    state = create_train_state(port, tx, device="cpu")
    state.teacher_params = {k: v * 0.5 for k, v in state.teacher_params.items()}
    path = str(tmp_path / "epoch_1.pth")
    save_checkpoint(path, state, meta=dict(epoch=1))
    bundle = init_detector(Config(dict(model=U.TINY_CFG)), checkpoint=path,
                           device="cpu")
    params = dict(bundle.detector.named_parameters())
    assert sorted(params) == sorted(state.teacher_params)
    for k, v in state.teacher_params.items():
        assert torch.equal(params[k], v), k
    for k, v in port.named_buffers():
        assert torch.equal(dict(bundle.detector.named_buffers())[k], v), k
    student = build_detector(U.TINY_CFG)
    load_weights(path, student, ema=False)
    _assert_trees_equal(_port_tree(student), _port_tree(port))


@pytest.mark.parametrize("fault", ["missing_file", "foreign_keys",
                                   "other_backbone", "lacks_a_key", "shape"])
def test_a_failed_load_raises(fault, tmp_path):
    _, _, port = _seeded("rla", 1)
    sd = dict(port.state_dict())
    path = tmp_path / "w.pth"
    # the baseline's weights into the flagship: their stems and necks share
    # names but not shapes
    errors = {"missing_file": FileNotFoundError, "foreign_keys": KeyError,
              "other_backbone": RuntimeError, "lacks_a_key": KeyError,
              "shape": RuntimeError}
    if fault == "foreign_keys":
        sd = {"fc.weight": torch.zeros(3, 3)}
    elif fault == "other_backbone":
        sd = dict(_seeded("resnet", 1)[2].state_dict())
    elif fault == "lacks_a_key":
        sd.pop("bbox_head.conv_cls.bias")
    elif fault == "shape":
        sd["bbox_head.conv_cls.bias"] = torch.zeros(3)
    if fault != "missing_file":
        torch.save(sd, path)
    with pytest.raises(errors[fault]):
        init_detector(Config(dict(model=U.TINY_CFG)), checkpoint=str(path),
                      device="cpu")


def test_train_detector_raises_on_a_missing_load_from(tmp_path):
    """The JAX package skips a configured path that does not exist; the
    port raises before it reads any data."""
    cfg = Config(dict(model=U.TINY_CFG, load_from=str(tmp_path / "no.pth"),
                      data=dict()))
    with pytest.raises(FileNotFoundError):
        train_detector(cfg, str(tmp_path / "work"), device="cpu")


def _write_config(path, model):
    path.write_text(f"model = {model!r}\noptimizer = {U.OPTIMIZER!r}\n"
                    f"optimizer_config = {U.OPTIMIZER_CONFIG!r}\n"
                    f"lr_config = {U.LR_CONFIG!r}\n")
    return str(path)


# orbax's save and restore take about 12 s on one worker: slow
@pytest.mark.parametrize("backend", [pytest.param("orbax", marks=pytest.mark.slow),
                                     "npz"])
def test_jax_checkpoint_converts_to_the_port(backend, tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent
                                    / "tools"))
    import jax_checkpoint_to_torch as conv

    _, variables = U.jax_detector_and_variables(U.TINY_CFG, seed=1)
    _, teacher = U.jax_detector_and_variables(U.TINY_CFG, seed=2)
    _, momentum = U.jax_detector_and_variables(U.TINY_CFG, seed=3)
    frozen = j_frozen_mask(variables["params"], 1)
    tx, _ = j_build_optimizer(variables["params"], U.OPTIMIZER,
                              U.OPTIMIZER_CONFIG, U.LR_CONFIG,
                              frozen_mask=frozen)
    state = j_create_train_state(variables, tx)
    state = state.replace(
        teacher_params=teacher["params"],
        opt_state=state.opt_state._replace(momentum=momentum["params"],
                                           count=jnp.asarray(7, jnp.int32)),
        step=jnp.asarray(7, jnp.int32), ema_ratio=jnp.asarray(0.98),
        ema_initialized=jnp.asarray(True))
    if backend == "npz":
        monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    jpath = str(tmp_path / "jax_ckpt")
    j_checkpoint.save_checkpoint(jpath, state, meta=dict(epoch=3))
    monkeypatch.undo()
    cfg_path = _write_config(tmp_path / "cfg.py", U.TINY_CFG)
    out = str(tmp_path / "port.pth")
    conv.convert(cfg_path, jpath, out)

    det = build_detector(U.TINY_CFG)
    tx_port, _ = build_optimizer_from_cfg(U.OPTIMIZER, U.OPTIMIZER_CONFIG,
                                          U.LR_CONFIG)
    port_state, meta = load_checkpoint(out, create_train_state(
        det, tx_port, device="cpu"))
    assert meta == dict(epoch=3)
    got = train_state_to_jax(port_state)
    # the port keeps no momentum for a frozen parameter: it crosses back as 0
    want_momentum = jax.tree_util.tree_map(
        lambda m, f: np.zeros_like(m) if f else np.asarray(m),
        momentum["params"], frozen)
    want = dict(params=variables["params"],
                batch_stats=variables["batch_stats"],
                teacher_params=teacher["params"],
                opt_state=dict(momentum=want_momentum, count=np.int32(7)),
                step=np.int32(7), ema_ratio=np.float32(0.98),
                ema_initialized=np.bool_(True))
    _assert_trees_equal(got, want)
