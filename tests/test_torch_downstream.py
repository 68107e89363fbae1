"""The downstream modes of the port against the JAX package on the CPU, at
tiny sizes: the rotation protocol (``rotate_batch`` from the same angles,
one train step against the JAX step body), the ModelNet-C battery (every
family's ``_corrupt_level`` at levels 0 and 4 from the JAX keys' draws,
``corruption_metrics`` with the reference log's golden numbers, the h5
path and an incomplete root), the saliency gradients against JAX's
per-cloud ``vmap(grad)``, ``reconstruct`` of the flagship and of one class
of each MaskSurf base, and the four CLI modes end to end through
``point_dae_torch.cli.main(argv, device="cpu")`` with their files and log
lines. Weights go through the bridge (``to_flax``); clouds are numpy
draws from seeds; random draws are fed to both packages."""
import copy
import functools
import logging
import os
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from __graft_entry__ import _tiny_config
from point_dae_tpu.engine import finetune as jft
from point_dae_tpu.engine import robustness as jrob
from point_dae_tpu.engine import rotation as jrot
from point_dae_tpu.engine.saliency import make_saliency_fn as j_saliency
from point_dae_tpu.engine.train_state import (TrainState as JTrainState,
                                              build_optimizer as j_build_optimizer)
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import transformer as jtr
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch import cli
from point_dae_torch.engine import robustness, rotation
from point_dae_torch.engine.saliency import make_saliency_fn
from point_dae_torch.engine.train_state import TrainState
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.common import ClsDraws
from point_dae_torch.models.transformer import ModelDraws
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, to_flax

from _jax_draws import level_draws, to_level_draws

from _torch_files import one_torch_thread  # noqa: F401

B, LR = 4, 1e-3
DGCNN = {"NAME": "DGCNN", "cls_dim": 5}
PT = {"NAME": "PointTransformer", "trans_dim": 32, "depth": 1, "drop_path_rate": 0.1,
      "cls_dim": 5, "num_heads": 2, "group_size": 8, "num_group": 16, "encoder_dims": 32}


def _t(a):
    return torch.from_numpy(np.array(a))


def _moved_stats(model, seed=9):
    """BatchNorm running statistics moved off (0, 1), so that eval reads
    them."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n.endswith("running_var"):
                b.copy_(_t(rng.uniform(0.5, 1.5, b.shape).astype(np.float32)))
            elif n.endswith("running_mean"):
                b.copy_(_t(rng.normal(0, 0.1, b.shape).astype(np.float32)))
    return model


class _Lines(logging.Handler):
    """The messages logged to one logger name."""

    def __init__(self, name):
        super().__init__()
        self.lines, self.name_ = [], name
        logging.getLogger(name).addHandler(self)

    def emit(self, record):
        self.lines.append(record.getMessage())

    def close(self):
        logging.getLogger(self.name_).removeHandler(self)
        super().close()


# ------------------------------------------------------------------ rotation

def test_rotate_batch_matches_jax():
    """z (one angle in +-pi) and so3 (Rz Ry Rx of Euler angles in +-pi)
    from the JAX keys' angles within 1e-6; none leaves the clouds."""
    pts = np.random.default_rng(0).normal(size=(B, 50, 3)).astype(np.float32)
    key = jax.random.key(4)
    keys = jax.random.split(key, B)
    angles = {"z": jax.vmap(lambda k: jax.random.uniform(
                  k, (), minval=-np.pi / 5.0 * 5.0, maxval=np.pi / 5.0 * 5.0))(keys),
              "so3": jax.vmap(lambda k: jax.random.uniform(
                  k, (3,), minval=-np.pi, maxval=np.pi))(keys)}
    for mode, ang in angles.items():
        want = jrot.rotate_batch(key, jnp.asarray(pts), mode)
        got = rotation.rotate_batch(_t(pts), mode, _t(ang))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1),
                                   np.linalg.norm(pts, axis=-1), rtol=1e-5)
    assert rotation.rotate_batch(_t(pts), "none") is not None
    assert torch.equal(rotation.rotate_batch(_t(pts), "none"), _t(pts))
    cfg = {"rotation": {"train": "so3", "test": "so3"}}
    assert rotation.protocol(cfg, None) == ("so3", "so3")
    assert rotation.protocol(cfg, "z2z") == ("z", "z") and rotation.protocol({}, None) == \
        ("z", "so3")


def _dropout_interceptor(masks):
    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"
                and not kwargs.get("deterministic", mod.deterministic)):
            return jnp.where(jnp.asarray(masks[mod.name]), args[0] / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)
    return intercept


def test_rotation_train_step_matches_jax():
    """One so3 step of a DGCNN (64 of 100 points, the head's dropout masks
    fed to both, an active clip of 1e-5) against the JAX package's step
    body as ``run_net_rotation`` defines it (rotate, ``fps_resample``, the
    train forward, plain cross-entropy, the clipped AdamW update): logits
    within 1e-4 of the largest, the loss within 1e-4 relative, every
    parameter after the update within 2e-3 relative and 5e-4 absolute (the
    head's two biases before a BatchNorm, whose true gradient is 0, within
    Adam's bound lr of their start in both)."""
    cfg = {"optimizer": {"type": "AdamW", "part": "all",
                         "kwargs": {"lr": LR, "weight_decay": 0.05}},
           "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300, "initial_epochs": 10}},
           "model": dict(DGCNN), "npoints": 64, "total_bs": B, "max_epoch": 300,
           "grad_norm_clip": 1e-5, "smooth": True}
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(B, 100, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=(B,)).astype(np.int32)
    masks = {"dp1": rng.uniform(size=(B, 512)) >= 0.5, "dp2": rng.uniform(size=(B, 256)) >= 0.5}
    model = build_model_from_cfg(ConfigDict(DGCNN), device="cpu", seed=1)
    params, stats = to_flax(model.state_dict())
    jmodel = j_build(JConfigDict(dict(DGCNN)))
    tx, _ = j_build_optimizer(JConfigDict(copy.deepcopy(cfg)), params, 10, 1e-5)
    state = JTrainState.create(jmodel.apply, params, stats, tx)
    key = jax.random.key(11)

    def step(state, pts, labels, key):
        k_rot, k_fps, k_drop = jax.random.split(key, 3)
        pts = jrot.rotate_batch(k_rot, pts, "so3")
        pts = jft.fps_resample(k_fps, pts, 64)

        def lossf(p):
            logits, mut = state.apply_fn({"params": p, "batch_stats": state.batch_stats}, pts,
                                         train=True, rngs={"dropout": k_drop, "droppath": k_drop},
                                         mutable=["batch_stats"])
            return jft.cross_entropy(logits, labels), (logits, mut["batch_stats"])

        (loss, (logits, bs)), grads = jax.value_and_grad(lossf, has_aux=True)(state.params)
        return state.apply_gradients(grads).replace(batch_stats=bs), loss, logits

    with fnn.intercept_methods(_dropout_interceptor(masks)):
        jstate, jloss, jlogits = jax.jit(step)(state, jnp.asarray(pts), jnp.asarray(labels), key)
    angles = jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=-np.pi, maxval=np.pi))(
        jax.random.split(jax.random.split(key, 3)[0], B))
    tstate = TrainState.create(model, ConfigDict(copy.deepcopy(cfg)), 10, 1e-5)
    tstep = rotation.make_rotation_train_step(model, cfg, "so3", device="cpu")
    m = tstep(tstate, _t(pts), _t(labels), draws=rotation.RotationDraws(
        _t(angles), None, ClsDraws([_t(masks["dp1"]), _t(masks["dp2"])], None)))
    want = np.asarray(jlogits)
    np.testing.assert_allclose(m["logits"].numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-4)
    init = _flatten(params)
    jp = _flatten(jax.tree_util.tree_map(np.asarray, jstate.params))
    tp = _flatten(to_flax(model.state_dict())[0])
    assert set(jp) == set(tp)
    for k in sorted(jp):
        if k in ("cls_head/fc1/bias", "cls_head/fc2/bias"):
            for got in (jp[k], tp[k]):
                assert np.abs(got - init[k]).max() <= LR * (1 + 1e-4), k
            continue
        np.testing.assert_allclose(tp[k], jp[k], rtol=2e-3, atol=5e-4, err_msg=k)


# --------------------------------------------------------------- corruptions

LEVEL_CASES = [(n, lv) for n in robustness.CORRUPTIONS for lv in (0, 4)]


@functools.lru_cache(maxsize=None)
def _level_cells():
    """Every (family, level) of LEVEL_CASES on the same (B, 64, 3) clouds
    in one JAX jit: (clouds, {case: (ops, ranks, JAX output)})."""
    pts = np.random.default_rng(2).normal(size=(B, 64, 3)).astype(np.float32)
    key = jax.random.key(21)
    out = jax.jit(lambda k, p: {f"{n}{lv}": level_draws(k, p, n, lv)
                                for n, lv in LEVEL_CASES})(key, jnp.asarray(pts))
    return pts, jax.device_get(out)


@pytest.mark.parametrize("name,level", LEVEL_CASES)
def test_corrupt_level_matches_jax(name, level):
    """From the JAX keys' draws (the resample's ranks JAX's own): the same
    points selected, coordinates within 1e-5; the masked families keep the
    cloud's point count and select from its valid rows."""
    pts, cells = _level_cells()
    ops, ranks, want = cells[f"{name}{level}"]
    got = robustness.corrupt_batch_level(_t(pts), name, level,
                                         draws=to_level_draws(name, ops, ranks))
    assert got.shape == pts.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


GOLDEN = {   # the reference's embedded ModelNet-C eval log (run.sh:70-114)
    "scale": [0.9141004862236629, 0.916936790923825, 0.9088330632090762,
              0.9051863857374393, 0.9043760129659644],
    "jitter": [0.9258508914100486, 0.893030794165316, 0.8160453808752026,
               0.5935980551053485, 0.37560777957860614],
    "rotate": [0.9278768233387358, 0.9193679092382496, 0.8841166936790924,
               0.7787682333873582, 0.6693679092382496],
    "dropout_global": [0.9145056726094003, 0.8877633711507293, 0.8338735818476499,
                       0.6815235008103727, 0.3521069692058347],
    "dropout_local": [0.9124797406807131, 0.8889789303079416, 0.8622366288492707,
                      0.7893030794165316, 0.6770664505672609],
    "add_global": [0.8375202593192869, 0.8091572123176661, 0.796191247974068,
                   0.7860615883306321, 0.7856564019448946],
    "add_local": [0.8630470016207455, 0.8140194489465153, 0.779578606158833,
                  0.7317666126418152, 0.6904376012965965]}


def test_corruption_metrics_match_jax():
    """The golden per-level OAs give the reference's published aggregates
    (mOA 0.801, mCE 0.857, RmCE 0.838) and JAX's every value exactly; so do
    random ones."""
    res = robustness.corruption_metrics(GOLDEN, clean_oa=0.9307131280388979)
    assert res == jrob.corruption_metrics(GOLDEN, clean_oa=0.9307131280388979)
    assert (round(res["mOA"], 3), round(res["mCE"], 3), round(res["RmCE"], 3)) == \
        (0.801, 0.857, 0.838)
    assert round(res["scale_CE"], 3) == 0.957
    rng = np.random.default_rng(3)
    per = {n: list(rng.uniform(0.3, 0.95, 5)) for n in robustness.CORRUPTIONS}
    assert robustness.corruption_metrics(per, 0.9) == jrob.corruption_metrics(per, 0.9)
    assert robustness.DGCNN_REF_ER == jrob.DGCNN_REF_ER
    assert robustness.CORRUPTIONS == jrob.CORRUPTIONS


def _write_modelnet_c(root, n=4):
    """clean.h5 (32 points a cloud) and every cell's file, the dropout
    cells with fewer points and the add cells with more."""
    import h5py

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, n)
    root.mkdir(parents=True, exist_ok=True)
    for split in ["clean"] + [f"{c}_{lv}" for c in robustness.CORRUPTIONS for lv in range(5)]:
        npts = 24 if "dropout" in split else 48 if "add" in split else 32
        with h5py.File(root / f"{split}.h5", "w") as f:
            f.create_dataset("data", data=rng.normal(size=(n, npts, 3)).astype(np.float32))
            f.create_dataset("label", data=labels.reshape(-1, 1))
    return labels


@pytest.fixture(scope="module")
def dgcnn_ckpt(tmp_path_factory):
    """A tiny DGCNN classifier's checkpoint, BatchNorm statistics moved."""
    model = _moved_stats(build_model_from_cfg(ConfigDict(DGCNN), device="cpu", seed=3))
    path = tmp_path_factory.mktemp("down_ck") / "ckpt-best.pth"
    torch.save({"base_model": model.state_dict()}, str(path))
    return str(path), model.eval()


def test_h5_path_matches_jax(tmp_path, dgcnn_ckpt):
    """``--test_corruption`` on ModelNet-C files: the raw eval step at each
    file's point count, then the JAX package's ``eval_corrupt_wrapper`` fed
    the same model's logits: every OA and aggregate equal, the log lines
    equal line for line. An incomplete root raises FileNotFoundError with
    JAX's message in both packages."""
    root = tmp_path / "mc"
    _write_modelnet_c(root)
    cfg = _cli_config(tmp_path, DGCNN, 64)
    lines = _Lines(os.path.splitext(os.path.basename(cfg))[0])
    got = cli.main(["--config", cfg, "--test_corruption", "--ckpts", dgcnn_ckpt[0],
                    "--modelnet_c_root", str(root), "--root_folder", str(tmp_path / "exp")],
                   device="cpu")
    lines.close()
    model = dgcnn_ckpt[1]

    def eval_fn(p):
        with torch.no_grad():
            return model(torch.from_numpy(np.asarray(p))).numpy()

    jlines = _Lines("jax_mc")
    want = jrob.eval_corrupt_wrapper(eval_fn, None, 4, data_root=str(root), logger="jax_mc")
    jlines.close()
    assert got == want and len(got) == 1 + 7 * 5 + 7 * 3 + 3
    ours = lines.lines[lines.lines.index(jlines.lines[0]):]
    assert ours[:len(jlines.lines)] == jlines.lines and len(jlines.lines) == 1 + 1 + 35 + 7 + 1
    os.remove(root / "rotate_3.h5")
    for fn in (robustness.eval_corrupt_wrapper, jrob.eval_corrupt_wrapper):
        with pytest.raises(FileNotFoundError, match="missing 1 file.s.: rotate_3.h5"):
            fn(eval_fn, None, 4, data_root=str(root))
    assert robustness.missing_modelnet_c_files(str(root)) == \
        jrob.missing_modelnet_c_files(str(root)) == ["rotate_3"]


# ------------------------------------------------------------------ saliency

@pytest.mark.parametrize("model_cfg", [DGCNN, PT], ids=["DGCNN", "PointTransformer"])
def test_saliency_matches_jax(model_cfg):
    """d logits[label] / d points in eval mode (BatchNorm statistics moved):
    one backward of the summed true-class logits against JAX's per-cloud
    ``vmap(grad)``, within 1e-3 of the largest."""
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(B, 128, 3)).astype(np.float32)
    labels = rng.integers(0, 5, B).astype(np.int32)
    model = _moved_stats(build_model_from_cfg(ConfigDict(model_cfg), device="cpu", seed=4))
    params, stats = to_flax(model.state_dict())
    jmodel = j_build(JConfigDict(dict(model_cfg)))
    want = np.asarray(j_saliency(jmodel, {"params": params, "batch_stats": stats})(
        jnp.asarray(pts), jnp.asarray(labels)))
    got = make_saliency_fn(model, device="cpu")(_t(pts), _t(labels)).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


# ---------------------------------------------------------------- reconstruct

RECON = ["PointCAE_transformer_fc_global_folding_local", "MaskSurf",
         "MaskSurf_v2_local_point_only", "MaskSurf_v2_local_global_point",
         "MaskSurf_v2_token_dis", "MaskSurf_v2_local_point_curve"]


def _recon_model_cfg(name):
    """A tiny f32 configuration of ``name``: G 16 x S 8, dim 32, depth 1."""
    cfg = _tiny_config()["model"]
    cfg["transformer_config"].pop("dtype")
    cfg["transformer_config"].update(trans_dim=32, encoder_dims=32, depth=1, rand_ratio="False",
                                     mask_ratio=0.6, mask_type="rand")
    if name != RECON[0]:
        cfg.update(NAME=name, corrupt_type=["clean"], loss="cdl2normal",
                   dvae_config={"num_tokens": 32, "encoder_dims": 16, "tokens_dims": 16,
                                "decoder_dims": 16})
    else:
        cfg["corrupt_type"] = ["Drop-Patch"]
    return cfg


@pytest.mark.parametrize("name", RECON)
def test_reconstruct_matches_jax(name):
    """``reconstruct`` in eval mode on the same clouds (xyz, unit normals,
    and a curvature for the curve class), weights and patch mask: every
    point output within 1e-4 of its largest, the mask and token_dis's token
    ids exactly; token_dis's tokenizer decoder, built by
    ``build_reconstruct``, has the paths and shapes JAX initialises through
    ``reconstruct`` (which leaves out the tokenizer's encoder and ``dgcnn_1``)."""
    cfg = _recon_model_cfg(name)
    model = build_model_from_cfg(ConfigDict(copy.deepcopy(cfg)), device="cpu", seed=6)
    if hasattr(model, "build_reconstruct"):
        model.build_reconstruct(torch.Generator().manual_seed(1))
    model = _moved_stats(model).eval()
    params, stats = to_flax(model.state_dict())
    rng = np.random.default_rng(8)
    nrm = rng.normal(size=(B, 128, 3))
    cols = [rng.normal(size=(B, 128, 3)), nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)]
    clean = np.concatenate(cols + [np.abs(rng.normal(size=(B, 128, 1)))], -1).astype(np.float32)
    mask = np.zeros((B, 16), bool)
    for b in range(B):
        mask[b, rng.permutation(16)[:9]] = True
    jmodel = j_build(JConfigDict(copy.deepcopy(cfg)))
    if name == "MaskSurf_v2_token_dis":
        shapes = jax.tree_util.tree_map(lambda a: np.empty(a.shape, np.float32),
                                        jax.eval_shape(lambda: jmodel.init(
                                            {k: jax.random.key(0) for k in ("params", "mask")},
                                            jnp.asarray(clean), train=False,
                                            method="reconstruct")))
        for ours, init in ((params, shapes["params"]), (stats, shapes["batch_stats"])):
            ours, init = _flatten(ours), _flatten(init)
            assert {k: v.shape for k, v in init.items()} == \
                {k: ours[k].shape for k in init}
            # the tokenizer's encoder and dgcnn_1 run on the training path only
            assert all(k.startswith(("dvae_teacher/encoder/", "dvae_teacher/dgcnn_1/"))
                       for k in set(ours) - set(init))
        assert any(k.startswith("dvae_teacher/decoder/") for k in _flatten(shapes["params"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "sample_patch_mask", lambda *a, **k: jnp.asarray(mask))
        want = jax.device_get(jax.jit(lambda x: jmodel.apply(
            {"params": params, "batch_stats": stats}, x, train=False, method="reconstruct",
            rngs={"mask": jax.random.key(0)}))(jnp.asarray(clean)))
    with torch.no_grad():
        got = model.reconstruct(_t(clean), draws=ModelDraws(_t(mask), None, None, None))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert g.shape == w.shape and np.abs(w).max() > 0
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    if name == RECON[0]:
        assert tuple(got[1].shape) == (B, 16, 36, 3)


# ------------------------------------------------------------------ the CLI

def _cli_config(tmp_path, model, npoints, size=16, **extra):
    """A classification config on Synthetic clouds of 64 points written
    under ``tmp_path``; returns its path."""
    syn = {"NAME": "Synthetic", "N_POINTS": 64, "num_classes": 5, "with_normal": True}
    (tmp_path / "syn.yaml").write_text(yaml.safe_dump(syn))
    split = {"_base_": str(tmp_path / "syn.yaml"),
             "others": {"subset": "test", "npoints": npoints, "size": size}}
    cfg = {"optimizer": {"type": "AdamW", "part": "all",
                         "kwargs": {"lr": LR, "weight_decay": 0.05}},
           "scheduler": {"type": "CosLR", "kwargs": {"epochs": 2}},
           "dataset": {s: copy.deepcopy(split) for s in ("train", "val", "test")},
           "model": dict(model), "npoints": npoints, "total_bs": 4, "max_epoch": 1,
           "grad_norm_clip": 10, **extra}
    path = tmp_path / f"down_{model['NAME'].lower()}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run_cli(tmp_path, cfg, flags):
    name = os.path.splitext(os.path.basename(cfg))[0]
    lines = _Lines(name)
    try:
        out = cli.main(["--config", cfg, "--root_folder", str(tmp_path / "exp")] + flags,
                       device="cpu")
    finally:
        lines.close()
    return out, lines.lines


def test_cli_so3_rotation(tmp_path):
    """``--so3_rotation --mode z2so3`` (winning over the config's so32so3):
    per epoch the JAX training and validation lines and ``ckpt-last``."""
    cfg = _cli_config(tmp_path, DGCNN, 32, rotation={"train": "so3", "test": "so3"})
    out, lines = _run_cli(tmp_path, cfg, ["--so3_rotation", "--mode", "z2so3"])
    train = [ln for ln in lines if ln.startswith("[Training]")]
    val = [ln for ln in lines if ln.startswith("[Validation]")]
    assert len(train) == len(val) == 2
    for e, (t, v) in enumerate(zip(train, val)):
        assert re.fullmatch(rf"\[Training\] EPOCH: {e} loss = \d+\.\d{{5}} acc = \d\.\d{{5}}", t)
        assert re.fullmatch(rf"\[Validation\] EPOCH: {e}  acc = \d+\.\d{{4}} \(z2so3\) "
                            rf"best = \d+\.\d{{4}}", v)
    exp = os.path.join(tmp_path, "exp", "down_dgcnn", os.path.basename(str(tmp_path)),
                       "default_z2so3")
    assert os.path.isfile(os.path.join(exp, "ckpt-last.pth"))
    assert out["state"].step == 2 * 4 and 0.0 <= out["best_acc"] <= 100.0


def test_cli_test_corruption_generated(tmp_path, dgcnn_ckpt):
    """``--test_corruption`` without ModelNet-C files: the generated path's
    warning, 1 + 35 cell lines, 7 family lines and the aggregate line, in
    the JAX dict formats; every cell drawn from a generator seeded with the
    seed, so a cell repeats."""
    cfg = _cli_config(tmp_path, DGCNN, 32)
    flags = ["--test_corruption", "--ckpts", dgcnn_ckpt[0], "--modelnet_c_root",
             str(tmp_path / "none")]
    out, lines = _run_cli(tmp_path, cfg, flags)
    assert any(ln.startswith("[Corruption] no ModelNet-C files found") for ln in lines)
    cells = [ln for ln in lines if ln.startswith("{'acc': ")]
    assert len(cells) == 35
    assert re.fullmatch(r"\{'acc': [01]\.?\d*, 'corruption': 'scale', 'level': 0\}", cells[0])
    fam = [ln for ln in lines if ln.startswith("{'CE': ")]
    assert len(fam) == 7 and fam[-1].endswith("'corruption': 'add_local', 'level': 'Overall'}")
    assert lines[-1] == (f"{{'RmCE': {round(out['RmCE'], 3)}, 'mCE': {round(out['mCE'], 3)}, "
                         f"'mOA': {round(out['mOA'], 3)}}}")
    pts = torch.randn(2, 32, 3)
    cells = [robustness.corrupt_batch_level(pts, "add_local", 3,
                                            generator=torch.Generator().manual_seed(0))
             for _ in range(2)]
    assert torch.equal(*cells)


def test_cli_vis_saliency(tmp_path, dgcnn_ckpt):
    """``--vis_saliency``: 8 batches of 8 clouds cut to ``npoints``, one
    ``.npz`` each with ``points``, ``grads`` (those of
    ``make_saliency_fn``) and ``labels``."""
    cfg = _cli_config(tmp_path, DGCNN, 48, size=72)
    out, lines = _run_cli(tmp_path, cfg, ["--vis_saliency", "--ckpts", dgcnn_ckpt[0]])
    files = sorted(os.listdir(out))
    assert files == [f"saliency_{i:03d}.npz" for i in range(8)]
    z = np.load(os.path.join(out, files[1]))
    assert z["points"].shape == z["grads"].shape == (8, 48, 3) and z["labels"].shape == (8,)
    want = make_saliency_fn(dgcnn_ckpt[1], device="cpu")(_t(z["points"]), _t(z["labels"]))
    np.testing.assert_allclose(z["grads"], want.numpy(), rtol=1e-5, atol=1e-7)
    assert lines[-1] == f"[Saliency] saved to {out}"


@pytest.mark.parametrize("name", [RECON[0], "MaskSurf_v2_token_dis", "DGCNN"])
def test_cli_test_reconstruction(tmp_path, name):
    """``--test`` on a pretrain config: 16 samples of batches of 4, each
    with its three renders (``.png.npy`` where matplotlib is missing) and
    its ``.npz``; a model without ``reconstruct`` raises AttributeError."""
    if name == "DGCNN":
        cfg = _cli_config(tmp_path, DGCNN, 64, size=20)
        with pytest.raises(AttributeError, match="reconstruct"):
            _run_cli(tmp_path, cfg, ["--test", "--ckpts", "unused.pth"])
        return
    model = build_model_from_cfg(ConfigDict(_recon_model_cfg(name)), device="cpu", seed=2)
    ckpt = str(tmp_path / "pre.pth")
    torch.save({"base_model": model.state_dict()}, ckpt)
    cfg = _cli_config(tmp_path, _recon_model_cfg(name), 64, size=20)
    out, lines = _run_cli(tmp_path, cfg, ["--test", "--ckpts", ckpt])
    files = os.listdir(out)
    stems = {f.split(".")[0] for f in files if f.endswith(".npz")}
    assert len(stems) == 16 and lines[-1] == f"[Vis] saved 16 samples to {out}"
    for stem in stems:
        for view in ("gt", "coarse", "rebuild"):
            assert any(f.startswith(f"{stem}_{view}.png") for f in files), (stem, view)
    z = np.load(os.path.join(out, sorted(stems)[0] + ".npz"))
    assert z["gt"].shape == (64, 3) and z["rebuild"].shape[-1] == 3
    assert any(ln.startswith("[LOAD] merged") and ln.endswith(" 0 unmatched") for ln in lines)


def test_visualize_corruptions(tmp_path):
    """Corruption_visualization.py: a Synthetic cloud rendered clean and
    under each corruption (resampled to ``npoints``), one image each."""
    from point_dae_torch.engine.visualization import visualize_corruptions

    types = ("affine_r3", "dropout_local", "add_global", "add_local", "jitter",
             "nonuniform_density")
    out = visualize_corruptions(str(tmp_path / "vis"), types=types, npoints=256,
                                device="cpu")
    files = sorted(os.listdir(out))
    assert [f.split(".")[0] for f in files] == sorted(("clean",) + types)
    assert all(f.endswith((".png", ".png.npy")) for f in files)
