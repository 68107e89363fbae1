"""The port's data parallelism (``point_dae_torch/parallel/mesh.py``) against
one process and against the JAX package's splits.

- The loader's per-rank index streams and the device cache's per-rank rows
  are the JAX package's, bit for bit (no process group needed).
- A step's draws sliced for a rank are the rows of the global batch's
  draws, and drawing them first replays the step's own draws bit for bit.
- ``tests/_torch_parallel_worker.py`` runs 2 gloo ranks on the CPU against
  one process with no group, held to ``tests/test_multihost.py``'s tiered
  contract: global batches bitwise, step-1 loss rtol 2e-5, step-2 loss rtol
  5e-3, ``run_pretrain``'s parameters within 5e-2 and its probe accuracy
  equal; BatchNorm (the layer and the fused EdgeConv's statistics) and the
  weighted chamfer equal the whole batch on one rank within rtol 1e-6,
  gradients included. A rank's input gradient is W times its rows' share
  of the global one (W the world size: every rank's loss is a share of the
  ranks' mean), so it is compared divided by W.

The processes meet through a ``FileStore`` in ``tmp_path`` (no port to race
for), with a 60 s group timeout and a 180 s limit a process.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tests._torch_files import one_torch_thread  # noqa: F401

from point_dae_torch.data.device_cache import cache_rows
from point_dae_torch.data.loader import DataLoader
from point_dae_torch.engine.finetune import (_sample_aug, augment, cross_entropy,
                                             fps_resample, make_finetune_step,
                                             make_vote_step, sample_scale_translate,
                                             scale_translate)
from point_dae_torch.engine.pretrain import (compute_loss, device_pipeline, init_model,
                                             make_train_step, sample_step_draws)
from point_dae_torch.engine.rotation import make_rotation_train_step, rotate_batch
from point_dae_torch.engine.train_state import TrainState
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.parallel import Mesh, draw_rows
from point_dae_torch.utils.config import ConfigDict

WORKER = os.path.join(os.path.dirname(__file__), "_torch_parallel_worker.py")


class _Rows:
    """A dataset whose item i is i (and a cloud filled with i)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"points": np.full((2, 3), i, np.float32), "label": i}


@pytest.mark.parametrize("num_hosts", [2, 4])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_indices_match_jax(num_hosts, shuffle, drop_last):
    """37 items in global batches of 3 a host: the tail global batch wraps
    (drop_last off) or goes (on), each host its contiguous slice."""
    from point_dae_tpu.data.loader import DataLoader as JaxLoader

    ds = _Rows(37)
    for host in range(num_hosts):
        kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3, num_hosts=num_hosts,
                  host_id=host)
        port, ref = DataLoader(ds, 3, **kw), JaxLoader(ds, 3, **kw)
        port.set_epoch(2)
        ref.set_epoch(2)
        assert len(port) == len(ref)
        np.testing.assert_array_equal(port._indices(), ref._indices())
        labels = np.concatenate([b["label"] for b in port]) if len(port) else []
        np.testing.assert_array_equal(labels, ref._indices())


@pytest.mark.parametrize("n,hosts", [(10, 2), (10, 4), (9, 4), (8, 2)])
def test_device_cache_rows_match_jax(monkeypatch, n, hosts):
    """Each rank's block of the wrap-padded set is the one the JAX
    ``build_device_cache`` loads for its host under a mesh of ``hosts``
    shards (its ``DeviceCache`` replaced by a recorder)."""
    from point_dae_tpu.data import device_cache as jdc

    seen = {}

    class Recorder:
        def __init__(self, points, **kw):
            seen["points"] = points
            self.nbytes, self.upload_seconds = points.nbytes, 0.0

    monkeypatch.setattr(jdc, "DeviceCache", Recorder)
    ds = _Rows(n)
    for host in range(hosts):
        jdc.build_device_cache(ds, mesh=types.SimpleNamespace(shape={"data": hosts}),
                               num_hosts=hosts, host_id=host, logger_name="t_cache_rows")
        rows = cache_rows(n, hosts, host)
        np.testing.assert_array_equal(seen["points"][:, 0, 0], [i % n for i in rows])


def _flagship_cfg(corrupt=("affine_r3", "Drop-Patch")):
    return ConfigDict({
        "optimizer": {"type": "AdamW", "part": "all",
                      "kwargs": {"lr": 0.001, "weight_decay": 0.05}},
        "scheduler": {"type": "CosLR", "kwargs": {"epochs": 2, "initial_epochs": 0}},
        "dataset": {"train": {"others": {"npoints": 64, "aug_type": ["scale", "rotate_z"],
                                         "corrupt_type": ["dropout_local", "jitter"]}}},
        "model": {"NAME": "PointCAE_transformer_fc_global_folding_local",
                  "corrupt_type": list(corrupt), "group_size": 8, "num_group": 8,
                  "loss": "cdl2",
                  "transformer_config": {"rand_ratio": "True", "mask_ratio": 0.6,
                                         "trans_dim": 32, "encoder_dims": 32, "depth": 2,
                                         "drop_path_rate": 0.1, "num_heads": 2,
                                         "decoder_depth": 1, "decoder_num_heads": 2}},
        "normal_weight": 0.005, "loss_type": "xyznormal"})


def _dgcnn_cfg():
    cfg = _flagship_cfg()
    cfg["dataset"]["train"]["others"]["corrupt_type"] = ["jitter"]
    cfg["model"] = ConfigDict({"NAME": "Point_CAE_DGCNN_FCOnly",
                               "corrupt_type": ["dropout_global", "random_dropout"]})
    cfg["loss_type"] = "xyz"
    return cfg


def _tfm(C=32, depth=2, **kw):
    return dict({"rand_ratio": "False", "mask_ratio": 0.6, "mask_type": "rand",
                 "trans_dim": C, "encoder_dims": C, "depth": depth, "drop_path_rate": 0.1,
                 "num_heads": 2, "decoder_depth": 1, "decoder_num_heads": 2}, **kw)


# (model, npoints, raw points a cloud, the pipeline's corruptions): one of
# each family whose step draws (its own ``sample_draws`` or none)
FAMILIES = {
    "masksurf": ({"NAME": "MaskSurf_v2", "corrupt_type": ["clean"], "all_patch": "False",
                  "group_size": 8, "num_group": 16, "loss": "cdl2normal",
                  "transformer_config": _tfm()}, 128, 160, ["jitter"]),
    "m2ae": ({"NAME": "Point_M2AE", "group_sizes": [8, 4, 4], "num_groups": [32, 16, 8],
              "encoder_depths": [1, 1, 1], "encoder_dims": [16, 32, 48],
              "decoder_depths": [1, 1], "decoder_dims": [48, 32], "decoder_up_blocks": [1, 1],
              "drop_path_rate": 0.1, "num_heads": 2, "mask_ratio": 0.8,
              "local_radius": [0.32, 0.64, 1.28],
              "corrupt_type": ["affine_r3", "rotate", "Drop-Patch"]}, 256, 300, ["clean"]),
    "mlmae": ({"NAME": "Point_MlMAE", "corrupt_type": ["Drop-Patch"], "group_size": 8,
               "num_group": 16, "loss": "cdl2", "feat_loss": ["high0", "high1"],
               "transformer_config": _tfm(depth=12)}, 128, 160, ["clean"]),
    "3detr": ({"NAME": "PointCAE_transformer_fc_global_fc_local_3detr",
               "corrupt_type": ["affine_r3", "Drop-Patch"], "all_patch": "False",
               "group_size": 8, "num_group": 16, "loss": "cdl2",
               "transformer_config": _tfm(enc_arch="3detr", rand_ratio="True")},
              128, 160, ["clean"]),
    "dvae": ({"NAME": "Point_dVAE", "corrupt_type": [], "group_size": 8, "num_group": 16,
              "num_tokens": 64, "encoder_dims": 32, "tokens_dims": 16, "decoder_dims": 16,
              "temperature": 0.7}, 128, 160, ["clean"]),
    "pointnet_dae": ({"NAME": "Point_CAE_PointNet", "corrupt_type": ["dropout_global"],
                      "loss": "cdl2"}, 128, 160, ["jitter"]),
    "pointnet2_dae": ({"NAME": "Point_MA2E_PointNetv2", "corrupt_type": [], "loss": "cdl2"},
                      528, 600, ["dropout_local"]),
    "supervised": ({"NAME": "PointCAE_transformer_supervised", "corrupt_type": ["affine_r3"],
                    "group_size": 8, "num_group": 16, "loss": "cdl2",
                    "transformer_config": _tfm(rand_ratio="True", cls_dim=5)},
                   128, 160, ["clean"]),
    "point_mae": ({"NAME": "Point_MAE", "corrupt_type": ["Drop-Patch"], "group_size": 8,
                   "num_group": 16, "loss": "cdl2",
                   "transformer_config": _tfm(mask_type="block")}, 128, 160, ["clean"]),
    "maskfeat_dgcnn": ({"NAME": "MaskFeat_dgcnn", "corrupt_type": ["clean"],
                        "all_patch": "False", "group_size": 8, "num_group": 16,
                        "loss": "cdl2normal", "transformer_config": _tfm()},
                       128, 160, ["clean"]),
    "coarse_to_fine": ({"NAME": "PointCAE_transformer_v6_corase2fine_transformer",
                        "corrupt_type": ["affine_r3"], "group_size": 8, "num_group": 16,
                        "loss": "cdl2", "transformer_config": _tfm(rand_ratio="True")},
                       128, 160, ["dropout_local"]),
}


def _family_cfg(name):
    model, npoints, _, corrupt = FAMILIES[name]
    cfg = _flagship_cfg()
    cfg["dataset"]["train"]["others"].update(npoints=npoints, corrupt_type=corrupt)
    cfg["model"] = ConfigDict(model)
    return cfg


def _step_against_inline(cfg, raw, labels=None):
    """Two steps' metrics against the same steps with every draw taken
    where it is used (the pipeline's, then the model's own, from one
    generator), bit for bit, and the generator left in the same state."""
    d = cfg["dataset"]["train"]["others"]
    aug, corrupt = tuple(d["aug_type"]), tuple(d["corrupt_type"])
    kw = {} if labels is None else {"labels": labels}
    got, gens = [], []
    for inline in (False, True):
        model = init_model(cfg, seed=0, device="cpu")
        state = TrainState.create(model, cfg, 4)
        step = make_train_step(model, cfg, device="cpu")
        gen = torch.Generator().manual_seed(7)
        losses = []
        for _ in range(2):
            if inline:
                corrupted, clean = device_pipeline(raw, aug, corrupt, int(d["npoints"]),
                                                   generator=gen, device="cpu")
                model.train()
                lx, ln = model(corrupted, clean, generator=gen, **kw)
                state.zero_grad()
                compute_loss(cfg["loss_type"], lx, ln, cfg["normal_weight"], 0.0).backward()
                state.apply_gradients()
            else:
                m = step(state, raw, generator=gen, **kw)
                lx, ln = m["loss_xyz"], m["loss_normal"]
            losses.append((float(lx.detach()), float(ln.detach())))
        got.append(losses)
        gens.append(gen.get_state())
    assert got[0] == got[1]
    assert torch.equal(gens[0], gens[1])


@pytest.mark.parametrize("make_cfg", [_flagship_cfg, _dgcnn_cfg], ids=["flagship", "dgcnn"])
def test_sampled_step_draws_replay_the_step(make_cfg):
    """The step takes its draws first (``sample_step_draws`` through
    ``row_drawer``), in the order they are used: its losses equal those of
    the same steps drawing each where it is used, bit for bit (a rank of a
    group relies on it to give each cloud its one-process draws)."""
    raw = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 96, 6)).astype(np.float32))
    _step_against_inline(make_cfg(), raw)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sampled_step_draws_replay_each_family(name):
    """The same for one model of every other family that draws in its step:
    the MaskSurf, Point-M2AE, MlMAE, 3DETR, dVAE, PointNet and PointNet++
    DAEs, the supervised head, Point-MAE, MaskFeat and the coarse-to-fine
    decoder."""
    _, _, n_raw, _ = FAMILIES[name]
    raw = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, n_raw, 6)).astype(np.float32))
    labels = torch.tensor([0, 1, 2, 3]) if name == "supervised" else None
    _step_against_inline(_family_cfg(name), raw, labels)


FINETUNE_MODELS = {
    "pointnet": ({"NAME": "PointNet_NoT", "cls_dim": 4}, "dg"),
    "transformer": ({"NAME": "PointTransformer", "trans_dim": 32, "depth": 2,
                     "drop_path_rate": 0.1, "cls_dim": 4, "num_heads": 2, "group_size": 8,
                     "num_group": 16, "encoder_dims": 32}, "scale_translate"),
}


@pytest.mark.parametrize("name", sorted(FINETUNE_MODELS))
def test_sampled_finetune_draws_replay_the_step(name):
    """The fine-tune step's draws (subset, augmentation, the head's
    dropouts and a transformer's stochastic depth) drawn first, bit for
    bit against the same step drawing each where it is used; the vote
    step's the same against its draws inline."""
    model_cfg, aug = FINETUNE_MODELS[name]
    cfg = ConfigDict({"optimizer": {"type": "AdamW", "kwargs": {"lr": 1e-3}},
                      "scheduler": {"type": "CosLR", "kwargs": {"epochs": 2}},
                      "model": model_cfg, "npoints": 1024, "train_aug": aug})
    pts = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 1300, 3)).astype(np.float32))
    labels = torch.tensor([0, 1, 2, 3])
    out, gens = [], []
    for inline in (False, True):
        model = build_model_from_cfg(cfg["model"], device="cpu", seed=0)
        state = TrainState.create(model, cfg, 2)
        step = make_finetune_step(model, cfg, device="cpu")
        vote = make_vote_step(model, cfg, times=2, device="cpu")
        gen = torch.Generator().manual_seed(3)
        if inline:
            p = augment(fps_resample(pts, 1024, None, gen), aug,
                        _sample_aug(aug, torch.empty((4, 1024, 3)), gen))
            model.train()
            ce = cross_entropy(model(p, generator=gen), labels)
            loss = float(ce.detach())
            state.zero_grad()
            ce.backward()
            state.apply_gradients()
            model.eval()
            with torch.no_grad():
                votes = sum(model(scale_translate(fps_resample(pts, 1024, None, gen),
                                                  *sample_scale_translate(4, gen, "cpu")))
                            for _ in range(2)) / 2
        else:
            loss = step(state, pts, labels, generator=gen)["loss"].item()
            votes = vote(pts, generator=gen)
        out.append((loss, votes))
        gens.append(gen.get_state())
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(gens[0], gens[1])


def test_sampled_rotation_draws_replay_the_step():
    """The rotation protocol's train step (z rotation, subset, the head's
    dropouts) against the same step drawing each where it is used."""
    cfg = ConfigDict({"optimizer": {"type": "AdamW", "kwargs": {"lr": 1e-3}},
                      "scheduler": {"type": "CosLR", "kwargs": {"epochs": 2}},
                      "model": {"NAME": "PointNet_NoT", "cls_dim": 4}, "npoints": 1024})
    pts = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 1300, 3)).astype(np.float32))
    labels = torch.tensor([0, 1, 2, 3])
    out = []
    for inline in (False, True):
        model = build_model_from_cfg(cfg["model"], device="cpu", seed=0)
        state = TrainState.create(model, cfg, 2)
        step = make_rotation_train_step(model, cfg, "z", device="cpu")
        gen = torch.Generator().manual_seed(5)
        if inline:
            p = fps_resample(rotate_batch(pts, "z", None, gen), 1024, None, gen)
            model.train()
            with torch.no_grad():
                loss = float(cross_entropy(model(p, generator=gen), labels))
        else:
            loss = step(state, pts, labels, generator=gen)["loss"].item()
        out.append((loss, gen.get_state()))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])


def test_draw_rows_keeps_each_ranks_rows():
    """On rank r of W, ``draw_rows`` returns rows [r B, (r + 1) B) of the
    global batch's draws along each tensor's batch axis (the stochastic
    depth masks' last), and the batch-wide draws whole."""
    model = init_model(_flagship_cfg(), seed=0, device="cpu")

    def sample(b, g):
        return sample_step_draws(model, ("scale",), ("dropout_local", "jitter"), 64, b, 96, g,
                                 "cpu")

    full = sample(6, torch.Generator().manual_seed(9))
    plans = {}
    for rank in range(3):
        part = draw_rows(sample, 2, torch.Generator().manual_seed(9), Mesh(3, rank), plans)
        rows = slice(2 * rank, 2 * rank + 2)
        pipe, fpipe = part.pipeline, full.pipeline
        assert torch.equal(pipe.corrupted, fpipe.corrupted[rows])
        assert torch.equal(pipe.clean, fpipe.clean[rows])
        assert torch.equal(pipe.augment[0], fpipe.augment[0][rows])
        assert torch.equal(pipe.corrupt.levels, fpipe.corrupt.levels[rows])
        assert torch.equal(pipe.corrupt.ops[0].seed_u, fpipe.corrupt.ops[0].seed_u[rows])
        assert torch.equal(part.model.mask, full.model.mask[rows])
        assert torch.equal(part.model.dp_encoder, full.model.dp_encoder[..., rows])
        # affine_r3's name order is one draw for the batch
        assert list(part.model.corrupt[0].perm) == list(full.model.corrupt[0].perm)
        assert torch.equal(part.model.corrupt[0].A, full.model.corrupt[0].A[:, rows])
    assert list(plans) == [6]


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """One process without a group and two gloo ranks, side by side."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs, outs = [], []
    for world, rank in ((1, 0), (2, 0), (2, 1)):
        out = str(tmp / f"out_{world}_{rank}.json")
        exp = tmp / f"exp_{world}"
        exp.mkdir(exist_ok=True)
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(rank), str(world), str(tmp / "store"), out, str(exp)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [json.load(open(o)) for o in outs]


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("part", ["bn", "edge_bn"])
def test_batch_norm_statistics_are_global(layouts, part):
    """Outputs, running statistics and gradients of half batches on 2 ranks
    equal the whole batch on one (rtol 1e-6; an absolute 1e-7 for the
    entries near zero)."""
    single, duo = layouts[0][part], layouts[1:]
    for r in duo:
        for key, val in single.items():
            _close(r[part][key], val, 1e-6, 1e-7)


def test_weighted_chamfer_is_global(layouts):
    """``masked_chamfer_l2`` with 3 weighted sets on rank 0 and 1 on rank 1:
    both ranks hold the global weighted mean, and the gradients are the
    whole batch's."""
    single = layouts[0]["chamfer"]
    for r in layouts[1:]:
        _close(r["chamfer"]["loss"], single["loss"], 1e-6)
        _close(r["chamfer"]["grad"], single["grad"], 1e-6, 1e-8)


def test_two_rank_dgcnn_steps_hold_the_contract(layouts):
    single, duo = layouts[0], layouts[1:]
    assert single["batch_hashes"] == duo[0]["batch_hashes"] == duo[1]["batch_hashes"]
    assert duo[0]["probe_losses"] == duo[1]["probe_losses"]
    _close(duo[0]["probe_losses"][:1], single["probe_losses"][:1], 2e-5)
    _close(duo[0]["probe_losses"][1:], single["probe_losses"][1:], 5e-3)


def test_two_rank_run_pretrain_matches_one(layouts):
    """The engine end to end: the same steps and probe accuracy, both
    ranks' parameters within 1e-6 of each other and 5e-2 of one
    process's; rank 0 alone wrote the checkpoints into the shared
    directory."""
    single, duo = layouts[0], layouts[1:]
    assert single["step"] == duo[0]["step"] == duo[1]["step"] > 0
    assert single["best_acc"] == duo[0]["best_acc"] == duo[1]["best_acc"]
    assert duo[0]["files"] == single["files"] == ["ckpt-best.pth", "ckpt-last.pth"]
    for k, v in single["digest"].items():
        _close(duo[1]["digest"][k], duo[0]["digest"][k], 1e-6)
        _close(duo[0]["digest"][k], v, 5e-2)


def test_two_rank_device_cache_holds_the_contract(layouts):
    """Each rank holds half the set; the served global batches are bitwise
    the one-process batches."""
    single, duo = layouts[0], layouts[1:]
    assert (single["cache_rows"], duo[0]["cache_rows"]) == (32, 16)
    assert single["cache_hashes"] == duo[0]["cache_hashes"] == duo[1]["cache_hashes"]
    _close(duo[0]["cache_losses"][:1], single["cache_losses"][:1], 2e-5)
    _close(duo[0]["cache_losses"][1:], single["cache_losses"][1:], 5e-3)


def test_two_rank_flagship_steps_hold_the_contract(layouts):
    """The tiny flagship (patch masks, affine_r3 and Drop-Patch, stochastic
    depth, bf16 products): both losses of step 1 within 2e-5, step 2
    within 5e-3."""
    single, duo = layouts[0]["flagship_losses"], layouts[1]["flagship_losses"]
    assert layouts[1]["flagship_losses"] == layouts[2]["flagship_losses"]
    _close(duo[0], single[0], 2e-5)
    _close(duo[1:], single[1:], 5e-3)


def test_two_rank_finetune_eval_matches_one(layouts):
    """A fine-tune model's eval loop (the padded tail batch split over the
    ranks, the logits gathered) and its vote loop (the global batch's
    draws) give one process's logits and accuracies."""
    single = layouts[0]
    for r in layouts[1:]:
        _close(r["eval_logits"], single["eval_logits"], 1e-5, 1e-6)
        assert r["eval_acc"] == single["eval_acc"]
        assert r["vote_acc"] == single["vote_acc"]


# the fine-tune head's Dense layers whose output feeds a BatchNorm: the
# BatchNorm takes out their bias, whose true gradient is then zero, and
# AdamW's first updates move it by +-lr at the sign of reduction-order noise
BN_FED_BIASES = ("cls_head_finetune.0.bias", "cls_head_finetune.3.bias")


def test_two_rank_run_finetune_matches_one(layouts):
    """One epoch of ``run_finetune`` (the row-split loader, the global
    batch's draws, the clip over averaged gradients) and its validation
    split over the ranks: the same steps and best accuracy, both ranks'
    parameters within 1e-6 of each other, and each parameter's digest
    within 1e-1 of one process's but the BatchNorm-fed biases'
    (``BN_FED_BIASES``, 9.8e-2 and 6.2e-2 measured). Measured with the
    worker on the CPU: 3.8e-2 at most (``dgcnn_encoder.bn5.bias``, whose
    entries are a few updates of +-lr from zero, so a sign flip of a small
    gradient shows), against 3.3e-1 with BatchNorm's statistics kept to
    each rank's rows and 2.9 with the gradient all-reduce dropped (the
    worker's ``local_stats`` and ``no_allreduce`` faults)."""
    single, duo = layouts[0], layouts[1:]
    assert single["ft_step"] == duo[0]["ft_step"] == duo[1]["ft_step"] > 0
    assert single["ft_best_acc"] == duo[0]["ft_best_acc"] == duo[1]["ft_best_acc"]
    assert single["ft_digest"].keys() == duo[0]["ft_digest"].keys()
    for k, v in duo[0]["ft_digest"].items():
        _close(duo[1]["ft_digest"][k], v, 1e-6)
        if k not in BN_FED_BIASES:
            _close(v, single["ft_digest"][k], 1e-1)
