"""Every shipped config that names a MaskSurf model or ``Point_dVAE``
builds in the port after ``propagate_corrupt_type`` (on the meta device:
the constructors run as on the CPU, without drawing the 30-55 million
initial weights of each), and its ``loss_type`` goes through
``compute_loss`` with the gradual weight of its schedule."""
import functools
import glob
import os

import pytest
import torch

from point_dae_torch.engine.pretrain import compute_loss, gradual_weight_for
from point_dae_torch.models import MODELS
from point_dae_torch.utils.config import cfg_from_yaml_file, propagate_corrupt_type

from _torch_files import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("MaskSurf", "MaskSurf_v2", "MaskSurf_v2_token_dis", "Point_dVAE")


@functools.lru_cache(maxsize=None)
def _all_cfgs():
    """{path: config} of every shipped config, each parsed once (a parse of
    all of them costs seconds)."""
    return {os.path.relpath(path, ROOT): cfg_from_yaml_file(path) for path in
            sorted(glob.glob(os.path.join(ROOT, "cfgs", "**", "*.yaml"), recursive=True))}


def _named(names):
    """{path: model NAME} of the shipped configs naming one of ``names``."""
    out = {}
    for rel, cfg in _all_cfgs().items():
        name = (cfg.get("model") or {}).get("NAME")
        if name in names:
            out[rel] = name
    return out


def _shipped():
    return _named(NAMES)


SHIPPED = _shipped()


def test_shipped_configs_found():
    counts = {n: sum(v == n for v in SHIPPED.values()) for n in NAMES}
    assert counts == {"MaskSurf": 4, "MaskSurf_v2": 20, "MaskSurf_v2_token_dis": 3,
                      "Point_dVAE": 1}, counts


@pytest.mark.parametrize("path", sorted(SHIPPED))
def test_shipped_config_builds_and_its_loss_type_runs(path):
    cfg = propagate_corrupt_type(cfg_from_yaml_file(os.path.join(ROOT, path)))
    with torch.device("meta"):
        model = MODELS.build(cfg["model"])
    assert sum(p.numel() for p in model.parameters()) > 0
    if cfg["model"]["NAME"] == "MaskSurf_v2_token_dis":
        assert not model.dvae_teacher.training
        assert not hasattr(model.dvae_teacher, "decoder")
    loss_type = cfg.get("loss_type", "xyz")
    gw = gradual_weight_for(loss_type, 3, int(cfg.get("max_epoch", 300)))
    loss = compute_loss(loss_type, torch.tensor(2.0), torch.tensor(0.5),
                        float(cfg.get("normal_weight", 1.0)), gw)
    assert torch.isfinite(loss) and float(loss) >= 2.0


# the Point-M2AE family and the frozen-feature extractors of the probes
PROBE_NAMES = ("Point_M2AE", "Point_M2AE_Finetune", "Point_M2AE_SVMFeature", "DGCNN_feat",
               "PointTransformerNoClassTokenSVMFeature")


def _shipped_probe():
    return _named(PROBE_NAMES)


SHIPPED_PROBE = _shipped_probe()


def test_m2ae_and_probe_configs_found():
    counts = {n: sum(v == n for v in SHIPPED_PROBE.values()) for n in PROBE_NAMES}
    assert counts == {"Point_M2AE": 7, "Point_M2AE_Finetune": 4, "Point_M2AE_SVMFeature": 3,
                      "DGCNN_feat": 11, "PointTransformerNoClassTokenSVMFeature": 1}, counts


@pytest.mark.parametrize("path", sorted(SHIPPED_PROBE))
def test_m2ae_or_probe_config_builds(path):
    """Each builds after ``propagate_corrupt_type``; a pretrain config's
    loss type goes through ``compute_loss``; every feature extractor
    config names a train and a test split, as the probes read them."""
    cfg = propagate_corrupt_type(cfg_from_yaml_file(os.path.join(ROOT, path)))
    with torch.device("meta"):
        model = MODELS.build(cfg["model"])
    assert sum(p.numel() for p in model.parameters()) > 0
    name = cfg["model"]["NAME"]
    if name == "Point_M2AE":
        loss_type = cfg.get("loss_type", "xyz")
        loss = compute_loss(loss_type, torch.tensor(2.0), torch.tensor(0.0),
                            float(cfg.get("normal_weight", 1.0)),
                            gradual_weight_for(loss_type, 3, int(cfg.get("max_epoch", 300))))
        assert float(loss) == 2.0
    elif name != "Point_M2AE_Finetune":
        assert {"train", "test"} <= set(cfg["dataset"])
        assert not hasattr(model, "cls_head_finetune")


# optimizer part modes, the linear probes, 3DETR, Point-MAE, the transformer
# MaskFeat, PointNet++ classification and Point_MlMAE
SLICE_NAMES = ("PointCAE_transformer_fc_global_fc_local_3detr", "Point_MAE",
               "MaskFeat_transformer", "Point_MlMAE", "PointNetv2",
               "PointTransformer_LinearClassification", "PointTransformerLinearClassification")


def _shipped_slice():
    """(configs naming a model of SLICE_NAMES, PointTransformer-family
    configs with a part mode other than ``all``)."""
    models, parts = {}, {}
    for rel, cfg in _all_cfgs().items():
        name = (cfg.get("model") or {}).get("NAME")
        if name in SLICE_NAMES:
            models[rel] = name
        part = (cfg.get("optimizer") or {}).get("part", "all")
        if name and name.startswith("PointTransformer") and part != "all":
            parts[rel] = part
    return models, parts


SHIPPED_SLICE, SHIPPED_PARTS = _shipped_slice()


def test_slice_configs_found():
    counts = {n: sum(v == n for v in SHIPPED_SLICE.values()) for n in SLICE_NAMES}
    assert counts == {"PointCAE_transformer_fc_global_fc_local_3detr": 7, "Point_MAE": 1,
                      "MaskFeat_transformer": 3, "Point_MlMAE": 1, "PointNetv2": 2,
                      "PointTransformer_LinearClassification": 5,
                      "PointTransformerLinearClassification": 1}, counts
    parts = {p: sum(v == p for v in SHIPPED_PARTS.values()) for p in ("only_new", "diff_lr")}
    assert parts == {"only_new": 13, "diff_lr": 3} and len(SHIPPED_PARTS) == 16, SHIPPED_PARTS


@pytest.mark.parametrize("path", sorted(SHIPPED_SLICE)
                         + sorted(p for p in SHIPPED_PARTS if p not in SHIPPED_SLICE))
def test_slice_config_builds(path):
    """Each builds after ``propagate_corrupt_type`` (on the meta device); a
    pretrain config's loss type goes through ``compute_loss``; a fine-tune
    config builds its optimizer and schedule, whose groups hold exactly the
    parameters its part mode trains (``only_new``: the ``cls`` ones;
    ``diff_lr``: all, the pretrained ones at 0.1 times the rate)."""
    from point_dae_torch.engine.train_state import TrainState

    cfg = propagate_corrupt_type(cfg_from_yaml_file(os.path.join(ROOT, path)))
    with torch.device("meta"):
        model = MODELS.build(cfg["model"])
    assert sum(p.numel() for p in model.parameters()) > 0
    if "loss_type" in cfg:
        loss_type = cfg["loss_type"]
        loss = compute_loss(loss_type, torch.tensor(2.0), torch.tensor(0.5),
                            float(cfg.get("normal_weight", 1.0)),
                            gradual_weight_for(loss_type, 3, int(cfg.get("max_epoch", 300))))
        assert torch.isfinite(loss) and float(loss) >= 2.0
        return
    state = TrainState.create(model, cfg, 100, cfg.get("grad_norm_clip"))
    assert state.grad_norm_clip == 10.0 and state.schedule(0) == cfg["optimizer"]["kwargs"]["lr"]
    held = {id(p): g["lr_scale"] for g in state.optimizer.param_groups for p in g["params"]}
    part = cfg["optimizer"].get("part", "all")
    for n, p in model.named_parameters():
        if part == "only_new":
            assert (id(p) in held) == ("cls" in n), n
        elif part == "diff_lr":
            assert held[id(p)] == (1.0 if "cls" in n else 0.1), n
        else:
            assert held[id(p)] == 1.0, n


def test_every_shipped_model_is_ported():
    """0 shipped configs name a model that the JAX package builds and the
    port lacks; 0 name one that neither builds."""
    from point_dae_tpu.models import MODELS as JMODELS

    names = {rel: (cfg.get("model") or {}).get("NAME") for rel, cfg in _all_cfgs().items()}
    assert len(names) == 588
    assert sorted(rel for rel, n in names.items() if n and n in JMODELS and n not in MODELS) \
        == []
    assert sorted(rel for rel, n in names.items() if n and n not in JMODELS) == []
    assert {"Point_MlMAE", "PointTransformerMlMAE",
            "PointTransformerMlMAELinearClassification"} <= set(MODELS.keys())


# the transformer heads of point_dae_tpu/models/transformer.py:430-1143,
# the last family of JAX-registered classes the port built
TRANSFORMER_HEADS = (
    "PointCAE_transformer", "PointCAE_transformer_fc_all", "PointCAE_transformer_fc_center",
    "PointCAE_transformer_fc_global_fc_local", "PointCAE_transformer_fold_all",
    "PointCAE_transformer_fold_center", "PointCAE_transformer_folding",
    "PointCAE_transformer_folding_global_fc_local",
    "PointCAE_transformer_folding_global_folding_local",
    "PointCAE_transformer_patch_center_only", "PointCAE_transformer_supervised",
    "PointCAE_transformer_v6_corase2fine_transformer",
    "PointCAE_transformer_v6_folding_corase2fine_transformer")
TRANSFORMER_HEADS_LEFT = ()       # none: the port lacks no JAX-registered name


def test_the_port_lacks_only_the_transformer_heads_left():
    """The port lacks no JAX-registered name (the transformer heads left
    to build are none): the 13 heads are registered, and every class of
    the JAX package's dae_pointnet, dae_pointnet2 and dae_dgcnn modules."""
    from point_dae_tpu.models import MODELS as JMODELS

    missing = sorted(n for n in JMODELS.keys() if n not in MODELS.keys())
    assert missing == sorted(TRANSFORMER_HEADS_LEFT) == []
    assert all(n in JMODELS.keys() and n in MODELS.keys() for n in TRANSFORMER_HEADS)
    cnn = [n for n in JMODELS.keys() if JMODELS.get(n).__module__.rsplit(".", 1)[-1]
           in ("dae_pointnet", "dae_pointnet2", "dae_dgcnn")]
    assert len(cnn) == 38 and all(n in MODELS.keys() for n in cnn)
