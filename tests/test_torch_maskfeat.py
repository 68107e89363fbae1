"""``MaskFeat_dgcnn`` of the port against the JAX package on the CPU, at a
tiny width (trans_dim 64, depth 2, G 16 x S 8 of 128 points) with the
teacher at its fixed widths: the same weights (carried through
``from_flax``; the teacher's BatchNorm running statistics set away from
their initial values), the same patch mask and stochastic-depth masks (fed
to the JAX model through monkeypatch). Compared: the loss and every
student gradient; then one AdamW step of the port leaves the teacher as it
was. Also the weight bridge both ways on a MaskFeat tree."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from point_dae_tpu.engine.pretrain import init_model as j_init_model
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models import transformer as jtr
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.engine.train_state import TrainState
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.transformer import ModelDraws
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

B, N, G, S, DEPTH = 2, 128, 16, 8, 2
CONFIG = {
    "optimizer": {"type": "AdamW", "part": "all",
                  "kwargs": {"lr": 0.001, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300, "initial_epochs": 10}},
    "dataset": {"train": {"others": {"npoints": N, "aug_type": ["norm"],
                                     "corrupt_type": ["clean"]}}},
    "model": {"NAME": "MaskFeat_dgcnn", "corrupt_type": ["clean"], "all_patch": "False",
              "group_size": S, "num_group": G, "loss": "cdl2normal",
              "transformer_config": {
                  "rand_ratio": "False", "mask_ratio": 0.6, "mask_type": "rand",
                  "trans_dim": 64, "encoder_dims": 64, "depth": DEPTH,
                  "drop_path_rate": 0.1, "num_heads": 4, "decoder_depth": 1,
                  "decoder_num_heads": 4}},
    "npoints": N, "total_bs": B, "loss_type": "xyznormal", "normal_weight": 0.005,
}


def _draws(rng):
    """9 of 16 patches masked a cloud (floor(0.6 * 16)); the encoder's keep
    masks with one drop in its second block (rate 0.1; the first block's
    rate is 0, the decoder's single block's too)."""
    mask = np.zeros((B, G), bool)
    for b in range(B):
        mask[b, rng.permutation(G)[:9]] = True
    dp = np.ones((DEPTH, 2, B), bool)
    dp[1, 0, 1] = False
    return mask, dp


def _jax_loss_and_grads(pts, mask, dp, monkeypatch):
    monkeypatch.setattr(jtr, "sample_patch_mask", lambda *a, **k: jnp.asarray(mask))

    def dp_masks(mod, dpr, batch, deterministic):
        if deterministic or max(dpr) == 0.0:
            return None
        assert len(dpr) == DEPTH
        return jnp.asarray(dp)

    monkeypatch.setattr(jlayers, "_stack_dp_masks", dp_masks)
    config = JConfigDict(copy.deepcopy(CONFIG))
    model = j_build(config["model"])
    params, stats = j_init_model(model, config, jnp.asarray(pts))
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map(np.asarray, stats)
    for name, bn in stats["teacher"].items():      # teacher BN away from (0, 1)
        leaf = bn["bn"] if "bn" in bn else bn
        leaf["mean"] = rng.normal(0, 0.1, leaf["mean"].shape).astype(np.float32)
        leaf["var"] = rng.uniform(0.5, 2.0, leaf["var"].shape).astype(np.float32)
    keys = {n: jax.random.key(i) for i, n in enumerate(("corrupt", "mask", "droppath",
                                                        "dropout"))}

    def loss_fn(p, x):
        (loss, _), _ = model.apply({"params": p, "batch_stats": stats}, x, x, train=True,
                                   rngs=keys, mutable=["batch_stats"])
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jnp.asarray(pts))
    return jax.device_get((params, stats)), float(loss), _flatten(
        jax.tree_util.tree_map(np.asarray, grads))


def test_maskfeat_dgcnn_loss_and_student_grads_match_jax(monkeypatch):
    """The loss to 1e-5 relative; each student gradient within 1e-4 of its
    largest magnitude (f32 products and sums in another order, through a
    max over patch features), or within 1e-6 of the largest gradient of
    the model where the tensor's own is rounding noise (a bias followed by
    BatchNorm has a gradient that is zero but for rounding: 1e-10 here);
    the teacher gets no gradient in either package. Then one AdamW step of the port moves the student and leaves
    every teacher parameter and running statistic bit for bit as it was."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask, dp = _draws(rng)
    (params, stats), loss_j, grads_j = _jax_loss_and_grads(pts, mask, dp, monkeypatch)

    config = ConfigDict(copy.deepcopy(CONFIG))
    model = build_model_from_cfg(config["model"], device="cpu")
    model.load_state_dict(from_flax(params, stats), strict=True)
    model.train()
    assert not model.teacher.training
    draws = ModelDraws(torch.from_numpy(mask), None, torch.from_numpy(dp), None)
    t = torch.from_numpy(pts)
    loss, zero = model(t, t, draws=draws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    assert float(zero) == 0.0
    grads_t = _flatten(to_flax({n: p.grad for n, p in model.named_parameters()
                                if p.grad is not None})[0])
    student = {k for k in grads_j if not k.startswith("teacher/")}
    assert set(grads_t) == student
    assert all(not np.any(grads_j[k]) for k in grads_j if k.startswith("teacher/"))
    top = max(np.abs(grads_j[k]).max() for k in student)
    for k in sorted(student):
        g = grads_j[k]
        np.testing.assert_allclose(grads_t[k], g, rtol=0,
                                   atol=max(1e-4 * np.abs(g).max(), 1e-6 * top), err_msg=k)

    teacher_before = {k: v.clone() for k, v in model.state_dict().items()
                      if k.startswith("teacher.")}
    student_before = model.increase_dim.weight.detach().clone()
    state = TrainState.create(model, config, steps_per_epoch=10)
    state.apply_gradients()
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in teacher_before.items())
    assert not torch.equal(model.increase_dim.weight, student_before)


def test_maskfeat_weights_carry_across_both_ways():
    """A MaskFeat_dgcnn state dict -> flax tree -> state dict is the
    identity, and the tree has the JAX model's paths and shapes."""
    config = JConfigDict(copy.deepcopy(CONFIG))
    jmodel = j_build(config["model"])
    params, stats = j_init_model(jmodel, config, jnp.zeros((B, N, 3), jnp.float32))
    model = build_model_from_cfg(ConfigDict(copy.deepcopy(CONFIG))["model"], device="cpu")
    sd = model.state_dict()
    p, s = to_flax(sd)
    shapes = lambda tree: {k: np.shape(v) for k, v in _flatten(
        jax.tree_util.tree_map(np.asarray, tree)).items()}
    assert shapes(p) == shapes(params) and shapes(s) == shapes(stats)
    back = from_flax(p, s)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
