"""The port's fused folding head (on the CPU: its plain version, forward
and hand-written backward) against the JAX package's Pallas kernel in
interpret mode, at C = F = 128 over the 6x6 grid.

Tolerances. Forward: rtol 1e-4, atol 1e-5 (both sides round to bf16 at the
same points and accumulate in f32; the sums differ in order). Gradients:
rtol 2**-6, atol 1e-4, one bf16 step, because every gradient is rounded to
bf16 after f32 partial sums that the two sides take in different orders.
An f32 sum that differs in its last bit can also land on the other side of
a bf16 rounding boundary of an *intermediate* activation or cotangent (about
one element in 2**16 does); that moves the rows it feeds by one bf16 step of
that intermediate. So at least 98% of a tensor's elements must meet the
tolerance above and every element the same tolerance widened by 2**-7
relative and absolute (half a bf16 step of a unit-sized intermediate)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.models.common import folding_grid
from point_dae_tpu.models.transformer import _FoldingLocalHead
from point_dae_tpu.ops import pallas_folding

from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models import transformer as ttr
from point_dae_torch.ops import folding
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import from_flax

from _torch_files import one_torch_thread  # noqa: F401

C = F = 128
FLIP = 2 ** -7


def _assert_close(got, want, rtol, atol, name=""):
    """``rtol``/``atol`` on at least 98% of the elements, and the same
    widened by FLIP on all of them (see the module docstring)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    assert close.mean() >= 0.98, (name, float(close.mean()))
    np.testing.assert_allclose(got, want, rtol=rtol + FLIP, atol=atol + FLIP,
                               err_msg=name)


GRID = folding_grid((6, 6), (-0.3, 0.3))


def _jax_params(seed):
    head = _FoldingLocalHead(F, dtype=jnp.bfloat16)
    params = head.init({"params": jax.random.key(seed)},
                       jnp.zeros((2, 3, C), jnp.float32))["params"]
    # biases initialise to zero; give them values so their terms are tested
    rng = np.random.default_rng(100 + seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    for stage in params.values():
        for dense in stage.values():
            dense["bias"] = (0.05 * rng.normal(size=dense["bias"].shape)
                             ).astype(np.float32)
    return params


def _stages(params, wrap):
    return tuple(tuple((wrap(np.array(params[s][f"dense{i}"]["kernel"])),
                        wrap(params[s][f"dense{i}"]["bias"])) for i in range(3))
                 for s in ("folding1", "folding2"))


def _port_model():
    cfg = {"NAME": "PointCAE_transformer_fc_global_folding_local",
           "corrupt_type": ["affine_r3", "Drop-Patch"], "all_patch": "False",
           "group_size": 8, "num_group": 16, "loss": "cdl2",
           "transformer_config": {
               "rand_ratio": "True", "mask_ratio": 0.6, "mask_type": "rand",
               "trans_dim": C, "encoder_dims": C, "depth": 1, "drop_path_rate": 0.0,
               "num_heads": 2, "decoder_depth": 1, "decoder_num_heads": 2,
               "dtype": "bf16"}}
    return build_model_from_cfg(ConfigDict(cfg), device="cpu")


@pytest.mark.parametrize("B,M", [(2, 4), (1, 7)])      # 7 tokens: not a tile multiple
def test_forward_matches_jax_kernel(B, M):
    params = _jax_params(1)
    x = np.random.default_rng(1).normal(size=(B, M, C)).astype(np.float32)
    p1, p2 = _stages(params, jnp.asarray)
    want = pallas_folding.fused_folding(jnp.asarray(x), jnp.asarray(GRID), p1, p2,
                                        tt=4, interpret=True)
    t1, t2 = _stages(params, torch.from_numpy)
    got = folding.fused_folding(torch.from_numpy(x), torch.from_numpy(GRID), t1, t2)
    assert got.shape == (B, M, 36, 3) and got.dtype == torch.float32
    _assert_close(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,M", [(2, 4), (1, 7)])
def test_gradients_match_jax_kernel(B, M):
    params = _jax_params(2)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, M, C)).astype(np.float32)
    tgt = rng.normal(size=(B, M, 36, 3)).astype(np.float32)

    def loss(x_, p1, p2):
        out = pallas_folding.fused_folding(x_, jnp.asarray(GRID), p1, p2, tt=4,
                                           interpret=True)
        return jnp.sum((out - tgt) ** 2)

    p1, p2 = _stages(params, jnp.asarray)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), p1, p2)

    xt = torch.from_numpy(x).requires_grad_()
    t1, t2 = _stages(params, lambda a: torch.from_numpy(a).requires_grad_())
    out = folding.fused_folding(xt, torch.from_numpy(GRID), t1, t2)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    got = (xt, t1, t2)
    names = ["x"] + [f"folding{s}/dense{i}/{leaf}" for s in (1, 2) for i in range(3)
                     for leaf in ("kernel", "bias")]
    leaves_w = jax.tree_util.tree_leaves(want)
    leaves_g = jax.tree_util.tree_leaves(got, is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert len(leaves_w) == len(leaves_g) == 13
    for name, w, g in zip(names, leaves_w, leaves_g):
        assert g.grad is not None and g.grad.dtype == torch.float32, name
        _assert_close(g.grad.numpy(), w, rtol=2 ** -6, atol=1e-4, name=name)


def test_head_fused_branch_matches_jax_head(monkeypatch):
    """The model's fused branch, with the weights carried through
    ``from_flax``, against ``_FoldingLocalHead(interpret=True)``; and the
    gate stays closed on a CPU tensor."""
    params = _jax_params(3)
    x = np.random.default_rng(3).normal(size=(2, 4, C)).astype(np.float32)
    head = _FoldingLocalHead(F, dtype=jnp.bfloat16, interpret=True)
    want = head.apply({"params": params}, jnp.asarray(x))

    model = _port_model()
    missing = model.load_state_dict(from_flax({"fold": params}, {}), strict=False)
    assert not missing.unexpected_keys
    assert not [k for k in missing.missing_keys if k.startswith("folding")]
    got = model._fold_fused(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _assert_close(got.detach().numpy(), want, rtol=1e-4, atol=1e-5)

    def boom(*a, **k):
        raise AssertionError("the fused folding gate opened on a CPU tensor")

    monkeypatch.setattr(ttr, "fused_folding", boom)
    plain = model._fold(torch.from_numpy(x))
    np.testing.assert_allclose(plain.detach().numpy(), np.asarray(want),
                               rtol=2 ** -5, atol=2 ** -6)   # strict bf16 chain


def test_supported_equals_jax_gate():
    for c in (64, 128, 192, 256, 384, 512):
        for f in (64, 128, 200, 384):
            for n in (1, 2, 36, 64, 65):
                assert folding.supported(c, f, n) == pallas_folding.supported(c, f, n)


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: here (no
    GPU) a tensor on another device must raise, not run the plain version."""
    def boom(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(folding._FoldCorePlain, "forward", boom)
    params = _jax_params(4)
    t1, t2 = _stages(params, lambda a: torch.from_numpy(a).to("meta"))
    x = torch.empty((2, 4, C), device="meta")
    grid = torch.from_numpy(GRID).to("meta")
    with pytest.raises(ValueError, match="expected one CUDA device"):
        folding.fused_folding(x, grid, t1, t2)
    with pytest.raises(ValueError, match="built for"):
        folding.fused_folding(torch.empty((2, 4, 64), device="meta"), grid, t1, t2)


# the gate grid: inside and around pallas_folding.supported
GATE_C = (64, 128, 256, 384, 512, 640)
GATE_F = (64, 128, 200, 384, 512, 640, 1024, 2048)
GATE_N = (1, 2, 36, 64, 65)


def test_kernel_takes_every_shape_of_the_gate():
    """The kernels (one-block form up to F 512, the wide form above) take
    exactly the shapes ``pallas_folding.supported`` admits."""
    for c in GATE_C:
        for f in GATE_F:
            for n in GATE_N:
                want = pallas_folding.supported(c, f, n)
                assert folding.kernel_takes(c, f, n) == want == folding.supported(c, f, n), (c, f, n)


def test_every_gate_shape_reaches_the_device_check():
    """Off the CPU the wrapper goes to its kernels for every shape inside the
    gate (here, without a card, the device check raises) and refuses the
    shapes outside it before any pointer is passed."""
    def stage(c, f, extra):
        z = lambda *shape: torch.empty(shape, device="meta")
        return ((z(c + extra, f), z(f)), (z(f, f), z(f)), (z(f, 3), z(3)))

    for c in GATE_C:
        for f in GATE_F:
            for n in GATE_N:
                x = torch.empty((1, 3, c), device="meta")
                grid = torch.empty((n, 2), device="meta")
                match = ("expected one CUDA device" if pallas_folding.supported(c, f, n)
                         else "built for")
                with pytest.raises(ValueError, match=match):
                    folding.fused_folding(x, grid, stage(c, f, 2), stage(c, f, 3))


def test_plain_version_matches_jax_kernel_at_f_512():
    """C = F = 512, the widest one-block form: the output and all thirteen
    gradients of the plain version against the Pallas kernel in interpret
    mode, 1 x 3 tokens over a 2 x 2 grid, with the tolerances of the module
    docstring."""
    width = 512
    grid = folding_grid((2, 2), (-0.3, 0.3))
    rng = np.random.default_rng(512)

    def dense(i, o):
        return ((rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
                (0.05 * rng.normal(size=(o,))).astype(np.float32))

    stages = ((dense(width + 2, width), dense(width, width), dense(width, 3)),
              (dense(width + 3, width), dense(width, width), dense(width, 3)))
    x = rng.normal(size=(1, 3, width)).astype(np.float32)
    tgt = rng.normal(size=(1, 3, 4, 3)).astype(np.float32)
    jstages = jax.tree_util.tree_map(jnp.asarray, stages)

    def run(x_, p1, p2):
        return pallas_folding.fused_folding(x_, jnp.asarray(grid), p1, p2, tt=4,
                                            interpret=True)

    def loss(x_, p1, p2):
        return jnp.sum((run(x_, p1, p2) - tgt) ** 2)

    want_out = run(jnp.asarray(x), *jstages)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), *jstages)

    xt = torch.from_numpy(x).requires_grad_()
    tstages = tuple(tuple((torch.from_numpy(k).requires_grad_(),
                           torch.from_numpy(b).requires_grad_()) for k, b in st)
                    for st in stages)
    out = folding.fused_folding(xt, torch.from_numpy(grid), *tstages)
    _assert_close(out.detach().numpy(), want_out, rtol=1e-4, atol=1e-5, name="out")
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    leaves_w = jax.tree_util.tree_leaves(want)
    leaves_g = [xt] + [t for st in tstages for pair in st for t in pair]
    assert len(leaves_w) == len(leaves_g) == 13
    for i, (w, g) in enumerate(zip(leaves_w, leaves_g)):
        _assert_close(g.grad.numpy(), w, rtol=2 ** -6, atol=1e-4, name=str(i))
