"""``remat``, ``remat_fold`` and the DGCNN encoder's ``remat`` in the port:
each recomputes a region in the backward instead of keeping its
activations, and changes nothing else. On the CPU the recompute runs the
same operations on the same inputs, so the losses, every gradient and every
BatchNorm running statistic equal the run without the key bit for bit
(the statistics move once: the recompute leaves them alone)."""
import copy

import pytest
import torch

from __graft_entry__ import _tiny_config
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.dgcnn import DGCNNEncoder
from point_dae_torch.utils.config import ConfigDict

from _torch_files import one_torch_thread  # noqa: F401

B = 4


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def _buffers(model):
    return {n: b.clone() for n, b in model.named_buffers() if "running" in n}


def _flagship(tcfg, bf16):
    cfg = _tiny_config()
    cfg["model"]["corrupt_type"] = ["Drop-Patch"]
    cfg["model"]["transformer_config"].update(tcfg)
    if not bf16:
        del cfg["model"]["transformer_config"]["dtype"]
    model = build_model_from_cfg(ConfigDict(cfg)["model"], device="cpu", seed=3)
    return model.train()


def _flagship_run(model, pts, draws):
    l1, l2 = model(pts, pts, draws=copy.deepcopy(draws))
    (l1 + l2).backward()
    return (l1.detach(), l2.detach()), _grads(model), _buffers(model)


@pytest.mark.parametrize("keys,bf16", [
    ({"remat": True}, False), ({"remat": True}, True), ({"remat_fold": "True"}, False),
    ({"remat_fold": "True", "fold_impl": "xla"}, True),
    ({"remat": True, "remat_fold": "True", "residual_dtype": "bf16"}, True)])
def test_flagship_remat_changes_nothing(keys, bf16):
    """The tiny flagship model with the keys against the same weights and
    draws without them: both losses, every gradient and the PatchEncoder's
    running statistics bit for bit; the recompute did run (the encoder's
    blocks, or the folding head, are a checkpoint's)."""
    base = {k: v for k, v in keys.items() if k not in ("remat", "remat_fold")}
    on, off = _flagship(keys, bf16), _flagship(base, bf16)
    assert on.MAE_encoder.blocks.remat == ("remat" in keys)
    assert on.remat_fold == ("remat_fold" in keys)
    off.load_state_dict(on.state_dict())
    gen = torch.Generator().manual_seed(5)
    pts = torch.randn((B, 128, 3), generator=gen)
    draws = on.sample_draws(B, gen, "cpu")
    lo, go, so = _flagship_run(on, pts, draws)
    lf, gf, sf = _flagship_run(off, pts, draws)
    assert all(torch.equal(a, b) for a, b in zip(lo, lf))
    assert set(go) == set(gf) and all(torch.equal(go[k], gf[k]) for k in go), \
        [k for k in go if not torch.equal(go[k], gf[k])]
    assert so and all(torch.equal(so[k], sf[k]) for k in so)


@pytest.mark.parametrize("impl", ["reference", "fused"])
@pytest.mark.parametrize("bf16", [False, True])
def test_dgcnn_encoder_remat_changes_nothing(impl, bf16):
    """The DGCNN encoder with ``remat`` (the reference layout with its kNN
    hoisted out of the checkpoint, the fused layout whole) against the same
    weights without it, one train-mode forward and backward: both outputs,
    the input's and every parameter's gradient, and the running statistics
    of all five BatchNorms bit for bit. The statistics moved from their
    initial values, once: a recompute that moved them again would leave
    them at m^2 running + ... instead."""
    dt = torch.bfloat16 if bf16 else None
    on = DGCNNEncoder(k=8, remat=True, dtype=dt, impl=impl,
                      generator=torch.Generator().manual_seed(1)).train()
    off = DGCNNEncoder(k=8, dtype=dt, impl=impl,
                       generator=torch.Generator().manual_seed(1)).train()
    x0 = torch.randn((2, 96, 3), generator=torch.Generator().manual_seed(2))
    out = []
    for enc in (on, off):
        x = x0.clone().requires_grad_()
        g, pw = enc(x)
        ((g.float() ** 2).sum() + pw.float().mean()).backward()
        out.append(((g.detach(), pw.detach(), x.grad), _grads(enc), _buffers(enc)))
    (ao, go, so), (af, gf, sf) = out
    assert all(torch.equal(a, b) for a, b in zip(ao, af))
    assert set(go) == set(gf) and all(torch.equal(go[k], gf[k]) for k in go)
    assert len(so) == 10 and all(torch.equal(so[k], sf[k]) for k in so)
    assert not torch.equal(so["bn1.running_mean"], torch.zeros(64))


def test_dgcnn_pretrain_config_reads_remat():
    """``remat: True`` in a ``Point_CAE_DGCNN_FCOnly`` config reaches its
    encoder, and a train-mode loss and backward run."""
    cfg = {"NAME": "Point_CAE_DGCNN_FCOnly", "corrupt_type": ["affine_r3"],
           "loss": "cdl2", "remat": True}
    model = build_model_from_cfg(ConfigDict(cfg), device="cpu").train()
    assert model.dgcnn_encoder.remat
    pts = torch.randn((2, 64, 3), generator=torch.Generator().manual_seed(4))
    loss, _ = model(pts, pts)
    loss.backward()
    assert torch.isfinite(loss) and model.dgcnn_encoder.conv1[0].weight.grad is not None
