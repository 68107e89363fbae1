"""The port stands alone (no JAX, no point_dae_tpu), its weight bridge is
exact, and its entry points refuse to run on the CPU unless asked to."""
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.utils.config import ConfigDict as JConfigDict
from point_dae_tpu.utils.convert_torch import convert_state_dict

from point_dae_torch.engine.pretrain import device_pipeline, init_model
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

from _torch_files import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "point_dae_torch"


def _model_cfg():
    cfg = _tiny_config()
    cfg["model"]["transformer_config"]["fold_impl"] = "xla"
    return cfg


# packages the card's machine does not have, or that the port must not use
BLOCKED = ("jax", "point_dae_tpu", "sklearn", "orbax", "h5py", "tensorboard")
_BLOCK = "import sys\nfor _m in %r:\n    sys.modules[_m] = None\n" % (BLOCKED,)


def _run(code, tmp_path=None):
    # one intra-op thread, as in the test modules (_torch_files.one_torch_thread)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", _BLOCK + code], cwd=tmp_path or ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    code = (
        "import pkgutil, importlib\n"
        "import point_dae_torch\n"
        "for m in pkgutil.walk_packages(point_dae_torch.__path__, 'point_dae_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and\n"
        "       (k == 'jax' or k.startswith(('jax.', 'jaxlib', 'flax', 'point_dae_tpu',\n"
        "                                    'sklearn', 'orbax', 'h5py', 'tensorboard')))]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('point_dae_torch')]))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[1]) >= 50      # the data and run layer joined


def test_no_source_file_names_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|point_dae_tpu|sklearn|orbax)\b",
                     re.M)
    top = re.compile(r"^(import|from)\s+(h5py|tensorboard|torch\.utils\.tensorboard)\b", re.M)
    for f in PKG.rglob("*.py"):
        assert not pat.search(f.read_text()), f
        assert not top.search(f.read_text()), f


def test_cli_pretrains_on_the_cpu_without_the_missing_packages(tmp_path):
    """A tiny DGCNN pretrain run through the CLI, SVM probe and checkpoints
    included, with every package of BLOCKED unimportable."""
    syn = ("{_base_: %s, others: {subset: train, npoints: 64, size: %d, seed: %d, "
           "N_POINTS: 128, aug_type: [norm], corrupt_type: [affine_r3, dropout_local]}}")
    base = ROOT / "cfgs" / "dataset_configs" / "Synthetic.yaml"
    (tmp_path / "cfgs").mkdir()
    (tmp_path / "cfgs" / "tiny.yaml").write_text(
        "optimizer: {type: AdamW, part: all, kwargs: {lr: 0.001, weight_decay: 0.05}}\n"
        "scheduler: {type: CosLR, kwargs: {epochs: 1}}\n"
        f"dataset:\n  train: {syn % (base, 16, 0)}\n  val: {syn % (base, 8, 1)}\n"
        f"  extra_train: {syn % (base, 8, 2)}\n"
        "model: {NAME: Point_CAE_DGCNN_FCOnly, corrupt_type: [], loss: cdl2}\n"
        "total_bs: 8\nmax_epoch: 0\nloss_type: xyz\n")
    out = _run("from point_dae_torch.cli import main\n"
               "out = main(['--config', 'cfgs/tiny.yaml', '--exp_name', 'iso'], device='cpu')\n"
               "print('steps', out['state'].step)\n", tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "2"
    exp = tmp_path / "experiments" / "tiny" / "cfgs" / "iso"
    assert {"ckpt-last.pth", "ckpt-best.pth", "config.yaml"} <= set(os.listdir(exp))
    log = next(exp.glob("*.log")).read_text()
    assert "[Training] EPOCH: 0" in log and "[Validation] EPOCH: 0  acc = " in log


def test_downstream_modes_without_h5py_and_matplotlib(tmp_path):
    """As on the card's machine (h5py and matplotlib missing too): the
    downstream engines and Point_MlMAE import; a ModelNet-C root of h5
    files raises the reader's ImportError instead of generating the
    corruptions; a render is saved as ``.png.npy``."""
    root = tmp_path / "mc"
    root.mkdir()
    for split in ["clean"] + [f"{c}_{lv}" for c in
                              ("scale", "jitter", "rotate", "dropout_global", "dropout_local",
                               "add_global", "add_local") for lv in range(5)]:
        (root / f"{split}.h5").write_bytes(b"")
    code = (
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "from point_dae_torch.engine import robustness, rotation, saliency, visualization\n"
        "from point_dae_torch.models import MODELS\n"
        "assert 'Point_MlMAE' in MODELS\n"
        "try:\n"
        f"    robustness.eval_corrupt_wrapper(lambda p: p, None, 4, data_root={str(root)!r})\n"
        "except ImportError as e:\n"
        "    print('refused:', e)\n"
        f"visualization._save_png({str(tmp_path / 'x.png')!r}, np.zeros((4, 4, 3), np.float32))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "refused: the ModelNet-C reader needs the h5py package" in out.stdout
    assert sorted(os.listdir(tmp_path)) == ["mc", "x.png.npy"]


def test_from_flax_to_flax_round_trip():
    """JAX init tree -> port state_dict -> JAX tree, exactly; and the port
    state_dict loads strictly into the port model."""
    cfg = JConfigDict(_model_cfg())
    model = j_build(cfg["model"])
    pts = np.zeros((2, 128, 3), np.float32)
    v = jax.jit(lambda: model.init({"params": jax.random.key(0),
                                    "mask": jax.random.key(1),
                                    "corrupt": jax.random.key(2)},
                                   pts, pts, train=False))()
    params, stats = jax.device_get((v["params"], v["batch_stats"]))
    sd = from_flax(params, stats)
    port = build_model_from_cfg(ConfigDict(_model_cfg())["model"], device="cpu")
    port.load_state_dict(sd, strict=True)
    p2, s2 = to_flax(sd)
    for a, b in ((_flatten(params), _flatten(p2)), (_flatten(stats), _flatten(s2))):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    sd2 = from_flax(*to_flax(port.state_dict()))
    for k, t in port.state_dict().items():
        assert torch.equal(sd2[k], t), k


def test_to_flax_agrees_with_reference_converter():
    """to_flax of the port's torch-named state_dict == the JAX package's
    convert_state_dict of the same tensors (with the encoder prefix
    stripped and re-rooted, as the reference loaders do)."""
    port = build_model_from_cfg(ConfigDict(_model_cfg())["model"], device="cpu")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    stripped = {k[len("MAE_encoder."):] if k.startswith("MAE_encoder.") else k: v
                for k, v in sd.items()}
    ref = convert_state_dict(stripped, "transformer")
    enc_tops = ("encoder/", "pos_embed/", "blocks/", "norm/")
    ref = {("MAE_encoder/" + k if k.startswith(enc_tops) else k): v
           for k, v in ref.items()}
    params, stats = to_flax(sd)
    got = {**_flatten(params), **_flatten(stats)}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


_DGCNN_CFG = {"NAME": "Point_CAE_DGCNN_FCOnly", "loss": "cdl2",
              "corrupt_type": ["affine_r3", "dropout_local"], "edgeconv_impl": "fused"}


def test_dgcnn_from_flax_to_flax_round_trip():
    """The DGCNN model's JAX init tree -> port state_dict (loads strictly)
    -> JAX tree, exactly."""
    model = j_build(JConfigDict(dict(_DGCNN_CFG)))
    pts = np.zeros((2, 64, 3), np.float32)
    v = jax.jit(lambda: model.init({"params": jax.random.key(0),
                                    "corrupt": jax.random.key(2)},
                                   pts, np.zeros((2, 1024, 3), np.float32),
                                   train=False))()
    params, stats = jax.device_get((v["params"], v["batch_stats"]))
    sd = from_flax(params, stats)
    port = build_model_from_cfg(ConfigDict(dict(_DGCNN_CFG)), device="cpu")
    port.load_state_dict(sd, strict=True)
    p2, s2 = to_flax(port.state_dict())
    for a, b in ((_flatten(params), _flatten(p2)), (_flatten(stats), _flatten(s2))):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dgcnn_to_flax_agrees_with_reference_converter():
    """to_flax of the port's torch-named DGCNN state_dict == the JAX
    package's convert_state_dict(family 'dgcnn') of the same tensors, the
    edge-projection weights as the reference's (out, 2C, 1, 1) Conv2d
    kernels and as the port's (out, 2C) ones."""
    port = build_model_from_cfg(ConfigDict(dict(_DGCNN_CFG)), device="cpu")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = to_flax(sd)
    got = {**_flatten(params), **_flatten(stats)}
    assert got["dgcnn_encoder/ec3/conv/kernel"].shape == (128, 128)
    as_conv2d = {k: v[:, :, None, None] if ".conv" in k else v for k, v in sd.items()}
    for src in (sd, as_conv2d):
        ref = {k: v for k, v in convert_state_dict(src, "dgcnn").items()
               if not k.endswith("num_batches_tracked")}
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_entry_points_refuse_cpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ConfigDict(_model_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model_from_cfg(cfg["model"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_pipeline(torch.zeros(2, 64, 6), ("norm",), ("clean",), 16)


def test_init_follows_flax_initializers():
    """lecun_normal kernels (truncated at 2 std), zero biases, unit norm
    scales, truncated_normal(0.02) mask token."""
    port = build_model_from_cfg(ConfigDict(_model_cfg())["model"], device="cpu")
    w = port.MAE_decoder.blocks[0].mlp.fc1.weight           # (256, 64)
    std = (1.0 / w.shape[1]) ** 0.5
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(port.MAE_decoder.blocks[0].mlp.fc1.bias.abs().max()) == 0.0
    assert float(port.MAE_encoder.norm.weight.min()) == 1.0
    assert float(port.mask_token.abs().max()) <= 0.04
    assert port.MAE_encoder.norm.eps == 1e-6


def test_norms_follow_flax():
    """BatchNorm normalises with the batch statistics and moves its running
    variance by the *biased* batch variance at flax momentum 0.9 (torch's
    BatchNorm1d uses the unbiased one); LayerNorm uses eps 1e-6."""
    import flax.linen as fnn

    from point_dae_torch.models.layers import BatchNorm, LayerNorm

    rng = np.random.default_rng(4)
    x = (rng.normal(size=(6, 5, 16)) * 3 + 1).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.key(0), x)
    yj, upd = bn.apply(v, x, mutable=["batch_stats"])
    tb = BatchNorm(16)
    yt = tb(torch.from_numpy(x))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-6)
    np.testing.assert_allclose(tb.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    ln = fnn.LayerNorm()
    yl = ln.apply(ln.init(jax.random.key(0), x), x)
    np.testing.assert_allclose(LayerNorm(16)(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(yl), rtol=1e-5, atol=1e-5)


def test_masked_count_and_knn_ties_follow_jax():
    """floor(float32(ratio) * float32(G)), which is 52 for 0.53 * 100 where
    a float64 product floors to 53; and kNN ties resolve to the lower index,
    as jax.lax.top_k orders them."""
    from point_dae_tpu import ops as jops
    from point_dae_tpu.models.transformer import static_num_masked as j_snm

    from point_dae_torch.models.transformer import static_num_masked
    from point_dae_torch.ops.geometry import knn

    assert static_num_masked(0.53, 100) == 52 != int(0.53 * 100)
    for ratio in (0.5, 0.53, 0.6, 0.7, 0.8):
        for g in (16, 64, 100, 128):
            assert static_num_masked(ratio, g) == j_snm(ratio, g)
    rng = np.random.default_rng(5)
    db = rng.normal(size=(2, 40, 3)).astype(np.float32)
    db[:, 20:] = db[:, :20]                          # every point twice
    q = db[:, :7]
    _, ij = jax.jit(lambda a, b: jops.knn(a, b, 6))(q, db)
    _, it = knn(torch.from_numpy(q), torch.from_numpy(db), 6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
