"""The port's EMD loss (``losses/emd.py``), point-cloud views
(``utils/pcviews.py``) and profiling utilities (``utils/profiling.py``)
against the JAX package's.

EMD: the match, the per-cloud cost, the loss and the loss's gradients with
respect to both clouds at N > M, N < M and N = M, within rtol 1e-5. Views:
the voxel grids bit for bit, the PLY text byte for byte and its read-back,
the three-view render's lit pixels equal and each within 2 float32 ulps
(both through ``native/pointio.cpp``, built with different flags).
Profiling: ``count_params`` of the tiny flagship bridged to flax,
``cost_analysis``'s flops of one product, a trace written to disk.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_files import one_torch_thread  # noqa: F401

from point_dae_tpu.losses import emd as jemd
from point_dae_tpu.utils import pcviews as jviews
from point_dae_tpu.utils import profiling as jprof
from point_dae_torch.losses import emd_approx, emd_cost, emd_loss
from point_dae_torch.utils import pcviews, profiling


def _clouds(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (2, n, 3)).astype(np.float32),
            rng.uniform(-1, 1, (2, m, 3)).astype(np.float32))


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("n,m", [(64, 48), (48, 64), (40, 40)])
def test_emd_matches_jax(n, m):
    a, b = _clouds(n, m)
    _close(emd_approx(torch.from_numpy(a), torch.from_numpy(b)),
           jax.jit(jemd.emd_approx)(a, b))
    _close(emd_cost(torch.from_numpy(a), torch.from_numpy(b)), jax.jit(jemd.emd_cost)(a, b))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    loss = emd_loss(ta, tb)
    loss.backward()
    jloss, (ga, gb) = jax.jit(jax.value_and_grad(jemd.emd_loss, argnums=(0, 1)))(a, b)
    _close(loss.detach(), jloss)
    _close(ta.grad, ga)
    _close(tb.grad, gb)


def test_emd_loss_holds_the_match_constant():
    """The gradient is the cost's with the match fixed: 2 sum_j m_ij (a_i -
    b_j) / N / B, as the reference's CUDA backward."""
    a, b = _clouds(16, 16, seed=1)
    ta = torch.from_numpy(a).requires_grad_(True)
    emd_loss(ta, torch.from_numpy(b)).backward()
    match = emd_approx(torch.from_numpy(a), torch.from_numpy(b))
    diff = torch.from_numpy(a)[:, :, None] - torch.from_numpy(b)[:, None]
    want = 2 * (match[..., None] * diff).sum(2) / 16 / 2
    torch.testing.assert_close(ta.grad, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("flatten", [True, False])
def test_volumes_match_jax(flatten):
    pts = np.random.default_rng(2).uniform(-1.2, 1.2, (3, 200, 3)).astype(np.float32)
    vol = pcviews.point_cloud_to_volume_batch(pts, 12, 1.0, flatten)
    np.testing.assert_array_equal(vol, jviews.point_cloud_to_volume_batch(pts, 12, 1.0, flatten))
    one = pcviews.point_cloud_to_volume(pts[0], 16)
    np.testing.assert_array_equal(pcviews.volume_to_point_cloud(one),
                                  jviews.volume_to_point_cloud(one))


def test_ply_matches_jax(tmp_path):
    pts = np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32)
    pcviews.write_ply(str(tmp_path / "port.ply"), pts)
    jviews.write_ply(str(tmp_path / "jax.ply"), pts)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    np.testing.assert_array_equal(pcviews.read_ply(str(tmp_path / "port.ply")),
                                  jviews.read_ply(str(tmp_path / "jax.ply")))


def test_three_views_match_jax():
    """The same pixels lit, each within 2 float32 ulps at 1.0: the JAX
    package builds ``pointio.cpp`` with ``-march=native`` (its Makefile),
    which lets the compiler fuse multiply-adds, the port without."""
    pts = np.random.default_rng(4).normal(size=(300, 3)).astype(np.float32)
    img = pcviews.point_cloud_three_views(pts, canvas_size=64)
    ref = jviews.point_cloud_three_views(pts, canvas_size=64)
    assert img.shape == ref.shape == (64, 192) and img.max() > 0
    np.testing.assert_array_equal(img > 0, ref > 0)
    np.testing.assert_allclose(img, ref, rtol=0, atol=2.5e-7)


def test_count_params_matches_jax():
    from point_dae_torch.engine.pretrain import init_model
    from point_dae_torch.utils.config import ConfigDict
    from point_dae_torch.utils.convert import to_flax

    cfg = ConfigDict({"model": {
        "NAME": "PointCAE_transformer_fc_global_folding_local",
        "corrupt_type": ["affine_r3", "Drop-Patch"], "group_size": 8, "num_group": 16,
        "transformer_config": {"mask_ratio": 0.6, "trans_dim": 64, "encoder_dims": 64,
                               "depth": 2, "num_heads": 2, "decoder_depth": 1,
                               "decoder_num_heads": 2}},
        "dataset": {"train": {"others": {"corrupt_type": ["clean"]}}}})
    model = init_model(cfg, seed=0, device="cpu")
    params, _ = to_flax(model.state_dict())
    assert profiling.count_params(model) == jprof.count_params(params) > 0
    assert profiling.count_params(dict(model.named_parameters())) == jprof.count_params(params)


def test_cost_analysis_flops_match_jax():
    a = np.ones((8, 16), np.float32)
    b = np.ones((16, 4), np.float32)
    got = profiling.cost_analysis(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    want = jprof.cost_analysis(jnp.matmul, a, b)
    assert got["flops"] == want["flops"] == 2 * 8 * 16 * 4
    assert np.isnan(got["bytes_accessed"])


def test_trace_writes_a_file_and_timer_laps(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(4) @ torch.ones(4)
    assert [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    timer = profiling.StepTimer()
    timer.lap(torch.ones(2))
    timer.lap()
    assert len(timer.laps) == 2 and timer.mean >= 0
