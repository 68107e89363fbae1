"""Every shipped config that names a MaskSurf model or ``Point_dVAE``
builds in the port after ``propagate_corrupt_type`` (on the meta device:
the constructors run as on the CPU, without drawing the 30-55 million
initial weights of each), and its ``loss_type`` goes through
``compute_loss`` with the gradual weight of its schedule."""
import glob
import os

import pytest
import torch

from point_dae_torch.engine.pretrain import compute_loss, gradual_weight_for
from point_dae_torch.models import MODELS
from point_dae_torch.utils.config import cfg_from_yaml_file, propagate_corrupt_type

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("MaskSurf", "MaskSurf_v2", "MaskSurf_v2_token_dis", "Point_dVAE")


def _shipped():
    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "cfgs", "**", "*.yaml"), recursive=True)):
        model = cfg_from_yaml_file(path).get("model") or {}
        if model.get("NAME") in NAMES:
            out[os.path.relpath(path, ROOT)] = model["NAME"]
    return out


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
