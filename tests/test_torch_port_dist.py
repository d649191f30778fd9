"""The port's data-parallel training and testing against one process and
the JAX package, on the CPU (gloo, tiny flagship at 64x96).

- (a) ``DistributedGroupSampler`` gives every rank the JAX package's
  order, for 1, 2 and 3 replicas over three epochs;
- (b) ``MultiDataLoader(n_shards=2)``'s global draws are the JAX
  package's shard for shard (the sample indices each shard loads, through
  an epoch boundary of both sources), and ``build_batch(n_shards=2)``
  gives the JAX package's rows and si pairs;
- (c) one spawn of two gloo ranks (``tests/torch_port_dist_worker.py``):
  each rank's loader yields its rows of the one-process global batch (the
  canvas agreed across ranks); one train step on each rank's shard
  matches one process on the global batch (losses and ``grad_norm``
  within 1e-5 relative, each parameter within 1e-3 of its update), and
  both ranks hold bit-identical parameters and teachers; a refresh split
  by chunk writes label files byte-equal to one process's, chunk ``c`` by
  rank ``c mod 2``; ``single_device_test`` split by batch gathers the one
  process's results in dataset order, and rank 0's metrics are its;
- (d) one rank under a ``file://`` process group: ``train_detector`` on
  the tiny semi config for two steps is bit-identical to no group.

Slow: the two-rank step against the JAX package's ``make_train_step`` on
the same global batch (one JAX device computes what the mesh computes),
and two epochs of ``train_detector`` over two ranks against one process.
"""

import copy
import json
import random

import numpy as np
import pytest
import torch

import torch_port_dist_worker as W
import torch_port_util as U
from dsl_tpu.data.samplers import DistributedGroupSampler as JaxSampler
from dsl_tpu_torch.config import Config
from dsl_tpu_torch.data.formatting import build_batch, format_sample
from dsl_tpu_torch.data.samplers import DistributedGroupSampler
from dsl_tpu_torch.parallel import dist
from dsl_tpu_torch.utils import synthetic_data
from torch_port_make_fixtures import FIXTURES, OUT

torch.set_num_threads(2)

CANVAS = (64, 96)
IMG_SCALE = (96, 64)
REPO = OUT.parents[1]
# losses and grad_norm of two ranks against one process: f32 sums over a
# batch of 10 against two sums of 5 differ in their last bits
STEP_REL = 1e-5
# each parameter against one process, as a share of its update
UPDATE_BAND = 1e-3


class _Flags:
    def __init__(self, flag):
        self.flag = np.asarray(flag, np.uint8)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_distributed_sampler_is_jax(world):
    flag = np.random.RandomState(world).randint(0, 2, 29)
    for per_gpu in (1, 2):
        for rank in range(world):
            port = DistributedGroupSampler(_Flags(flag), per_gpu, world, rank, 7)
            ref = JaxSampler(_Flags(flag), per_gpu, world, rank, 7)
            assert len(port) == len(ref)
            for epoch in range(3):
                assert list(port.set_epoch(epoch)) == list(ref.set_epoch(epoch))


def test_global_draws_are_jax_shards():
    """Two epochs of the merged loader: the port's draws, shard by shard,
    are the indices the JAX loader's shards load, and the one-process
    global batch is JAX's (boxes, weights, image shapes, si pairs)."""
    port = W.multi_loader(2, None)
    ref = W.multi_loader(2, None, jax=True)
    for epoch in range(2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        lab, unl = ref.label_loader.dataset, ref.unlabel_loader.dataset
        for draw, (got, want) in zip(port.draws(), zip(port, ref)):
            lab_calls, unl_calls = list(lab.calls), list(unl.calls)
            lab.calls.clear()
            unl.calls.clear()
            assert [i for l, _ in draw for i in l] == lab_calls
            assert [i for _, u in draw for i in u] == unl_calls
            got = W.batch_rows(got)
            for key in ("gt_bboxes", "source_weight", "img_shapes"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got["images"].shape[2:] == want["images"].shape[1:3]
            assert got["images"].shape[0] == len(want["images"]) == 10
            for key in ("full", "half"):
                np.testing.assert_array_equal(got["si_pair"][key],
                                              want["si_pair"][key])
    assert (list(got["si_pair"]["full"]), list(got["si_pair"]["half"])) == (
        [3, 8], [4, 9])


def test_build_batch_shards_keep_their_half_copies():
    samples = [format_sample(dict(img=torch.full((40, 60, 3), float(i)),
                                  gt_bboxes=np.asarray([[i, 0, i + 4, 4]]),
                                  gt_labels=np.asarray([i])),
                             CANVAS) for i in range(4)]
    whole = build_batch(samples, scale_invariant=True, n_shards=2)
    for s in range(2):
        part = build_batch(samples[2 * s:2 * s + 2], scale_invariant=True)
        assert torch.equal(whole["images"][3 * s:3 * s + 3], part["images"])
        assert (int(whole["si_pair"]["full"][s]) - 3 * s,
                int(whole["si_pair"]["half"][s]) - 3 * s) == (
            int(part["si_pair"]["full"][0]), int(part["si_pair"]["half"][0]))
    with pytest.raises(ValueError, match="shards"):
        build_batch(samples[:3], scale_invariant=True, n_shards=2)


@pytest.fixture(scope="module")
def semicoco(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_data")
    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()]
    return synthetic_data.make_semicoco_dir(root, sources, 2, 6, n_val=9)


def test_two_ranks_are_one_process(semicoco, tmp_path):
    """One spawn of two gloo ranks: the loader's rows, a train step, a
    refresh and an evaluation, each against one process (computed here
    while the ranks run)."""
    shared = tmp_path / "shared_store"
    shared.mkdir()
    spawned = W.spawn(2, tmp_path, "cpu", [
        ("loader", {}),
        ("step", dict(width="tiny", canvas=CANVAS, per_source=1)),
        ("refresh", dict(width="tiny", paths=semicoco, store_dir=str(shared),
                         img_scale=IMG_SCALE, canvas=CANVAS)),
        ("evaluate", dict(width="tiny", paths=semicoco, img_scale=IMG_SCALE,
                          canvas=CANVAS))])
    reference = W.reference_step("tiny", 2, CANVAS, "cpu", per_source=1)
    one_store = tmp_path / "one_store"
    one_store.mkdir()
    one_written = W.run_refresh("tiny", semicoco, str(one_store), "cpu", None,
                                IMG_SCALE, CANVAS)
    one_metrics, one_results = W.run_evaluate("tiny", semicoco, "cpu", None,
                                              IMG_SCALE, CANVAS)
    ranks = W.collect(spawned, 2, tmp_path)

    # the loader: each rank's batch is its rows of the global batch
    whole = [W.batch_rows(b) for b in W.multi_loader(2, None)]
    for r, res in enumerate(ranks):
        assert len(res["loader"]) == len(whole) == 3
        for got, want in zip(res["loader"], whole):
            for key, value in got.items():
                if key != "si_pair":
                    np.testing.assert_array_equal(value, want[key][5 * r:5 * r + 5])
            assert (int(got["si_pair"]["full"][0]), int(got["si_pair"]["half"][0])
                    ) == (3, 4)

    # the step
    steps = [res["step"] for res in ranks]
    assert steps[0]["metrics"] == steps[1]["metrics"]
    assert steps[0]["params_sha"] == steps[1]["params_sha"]
    assert steps[0]["teacher_sha"] == steps[1]["teacher_sha"]
    near = W.compare_step(steps[0]["metrics"], steps[0]["after"], reference)
    assert near["metrics_rel"] <= STEP_REL, near
    assert near["update_band"] <= UPDATE_BAND, near

    # the refresh: chunk c by rank c mod 2, the files one process's
    chunks = [one_written[i:i + W.REFRESH_BATCH]
              for i in range(0, len(one_written), W.REFRESH_BATCH)]
    for r, res in enumerate(ranks):
        assert res["refresh"] == [n for c, names in enumerate(chunks)
                                  if c % 2 == r for n in names]
    assert U.tree_of(shared) == U.tree_of(one_store)
    assert len(U.tree_of(shared)) == 6

    # the evaluation: every rank holds the results in dataset order
    for r, res in enumerate(ranks):
        metrics, results = res["evaluate"]
        assert (metrics == one_metrics) if r == 0 else metrics is None
        assert len(results) == len(one_results) == 9
        for (gd, gl), (wd, wl) in zip(results, one_results):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)


def _tiny_semi_cfg(paths) -> dict:
    cfg = Config.fromfile(str(REPO / "configs/fcos_semi/RLA_r50_fcos_semi_dsl.py"))
    cfg = U.cut_flagship(cfg._cfg_dict, max_epochs=1, start_point=1)
    cfg = synthetic_data.semi_config(cfg, paths)
    cfg["model"] = copy.deepcopy(U.TINY_CFG)
    cfg["canvas_hw"] = CANVAS
    pipeline = [dict(type="LoadImageFromFile"),
                dict(type="LoadAnnotations", with_bbox=True),
                dict(type="Resize", img_scale=[IMG_SCALE, (96, 48)],
                     multiscale_mode="value", keep_ratio=True),
                dict(type="RandomFlip", flip_ratio=0.5),
                dict(type="Normalize", **W.NORM), dict(type="Pad", size_divisor=32)]
    for key in ("train", "unlabel_train"):
        cfg["data"][key]["pipeline"] = pipeline
    cfg["data"]["unlabel_pred"]["pipeline"][1]["img_scale"] = IMG_SCALE
    cfg["log_config"] = dict(interval=1)
    return cfg


def _train(tmp_path, tag: str):
    from dsl_tpu_torch.apis.train import train_detector

    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()]
    paths = synthetic_data.make_semicoco_dir(tmp_path / tag, sources, 2, 4)
    runner = train_detector(Config(_tiny_semi_cfg(paths)),
                            str(tmp_path / f"{tag}_work"), device="cpu",
                            variables=W.seeded_variables("tiny"))
    return runner, U.tree_of(paths["unlabel_store"])


def test_one_rank_under_a_group_is_no_group(tmp_path):
    """``train_detector`` with one rank in a ``file://`` gloo group runs no
    collective: its state, label files and loss log are the ungrouped
    run's, bit for bit."""
    plain, plain_files = _train(tmp_path, "plain")
    dist.init_group("gloo", f"file://{tmp_path}/store", 0, 1)
    try:
        assert dist.get_world_size() == 1 and dist.group() is None
        grouped, grouped_files = _train(tmp_path, "grouped")
    finally:
        dist.destroy()
    assert plain.state.step == grouped.state.step == 2
    a, b = plain.state.student.state_dict(), grouped.state.student.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(plain.state.teacher_params[k], grouped.state.teacher_params[k])
               for k in plain.state.teacher_params)
    assert plain_files == grouped_files
    assert (plain.log_buffer.history["loss"]
            == grouped.log_buffer.history["loss"])


def test_pipeline_generators_of_rank_zero_are_the_seeds():
    from dsl_tpu_torch.apis.train import pipeline_generators

    rng, pyrng = pipeline_generators(3, 0)
    assert rng.randint(1 << 30) == np.random.RandomState(3).randint(1 << 30)
    assert pyrng.random() == random.Random(3).random()
    other, _ = pipeline_generators(3, 1)
    assert other.randint(1 << 30) != np.random.RandomState(3).randint(1 << 30)


@pytest.mark.slow
def test_two_ranks_step_as_the_jax_mesh(tmp_path):
    """The two-rank step against the JAX package's ``make_train_step`` on
    the same global batch and weights (one JAX device computes what the
    mesh computes: the normalizers and si-soft over the whole batch)."""
    import jax

    from dsl_tpu.train import (build_optimizer_from_cfg, create_train_state,
                               frozen_backbone_mask, make_train_step)

    det, var = U.jax_detector_and_variables(U.TINY_CFG, seed=0)
    torch.save(var, tmp_path / "variables.pt")
    frozen = frozen_backbone_mask(var["params"], 1)
    tx, _ = build_optimizer_from_cfg(
        var["params"], U.OPTIMIZER, U.OPTIMIZER_CONFIG, U.LR_CONFIG,
        steps_per_epoch=U.STEPS_PER_EPOCH, frozen_mask=frozen)
    step = jax.jit(make_train_step(det, tx, ema_interval=1, ema_start_iter=1,
                                   frozen_mask=frozen))
    _, want = step(create_train_state(var, tx, ema_ratio=0.99),
                   U.jax_batch(W.global_batch(W.shards(2, CANVAS))))
    ranks = W.collect(W.spawn(2, tmp_path, "cpu", [
        ("step", dict(width="tiny", canvas=CANVAS,
                      variables=str(tmp_path / "variables.pt")))]), 2, tmp_path)
    got = ranks[0]["step"]["metrics"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - float(v)) <= 1e-4 * abs(float(v)) + 1e-7, (k, got[k], v)


@pytest.mark.slow
def test_two_epochs_over_two_ranks(tmp_path):
    """``train_detector`` on the tiny semi config over two gloo ranks (the
    launcher's path, spawned here): it runs both epochs, every unlabeled
    label file is rewritten, and rank 0 alone writes the log and the
    checkpoints."""
    sources = [(str(OUT / f"{n}.jpg"), h, w) for n, (h, w, _) in FIXTURES.items()]
    paths = synthetic_data.make_semicoco_dir(tmp_path / "data", sources, 4, 8)
    cfg = _tiny_semi_cfg(paths)
    cfg["runner"]["max_epochs"] = 2
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    before = U.tree_of(paths["unlabel_store"])
    ranks = W.collect(W.spawn(2, tmp_path, "cpu", [
        ("train", dict(cfg=str(tmp_path / "cfg.json"),
                       work_dir=str(tmp_path / "work")))]), 2, tmp_path)
    after = U.tree_of(paths["unlabel_store"])
    assert set(after) == set(before)
    assert all(after[n] != before[n] for n in after)
    assert ranks[0]["train"] == ranks[1]["train"]
    assert ranks[0]["train"]["step"] == 4
    assert (tmp_path / "work" / "epoch_2.pth").exists()
    assert (tmp_path / "work" / "train.log.json").read_text().count("\n") == 4
