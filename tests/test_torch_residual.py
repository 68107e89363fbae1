"""The bf16 residual stream of the port (``transformer_config.residual_dtype:
bf16``) and the MLP kernel it reaches, against the JAX package on the CPU:

- ``fused_mlp_plain``, the twin of the port's ``mlp`` kernels, against the
  JAX package's ``fused_mlp`` in interpret mode, forward and all five
  gradients, at R 512, C 128, H 512;
- the block's MLP dispatch against ``point_dae_tpu/models/layers.py:331-359``
  case by case;
- the flagship model under ``residual_dtype: bf16`` and under
  ``embed_all_patches`` at ``_tiny_config`` widths, with the same weights
  (through ``from_flax``) and the same draws.

On the CPU neither package takes a kernel: the JAX block asks for a TPU,
the port's for a CUDA tensor, so both run the plain bf16 chain (bias and
GELU at bf16), which is not the kernels' arithmetic (hidden in f32)."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_config
from point_dae_tpu.engine.pretrain import init_model as j_init_model
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models import transformer as jtr
from point_dae_tpu.ops import pallas_mlp
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.models import build_model_from_cfg, layers as tlayers
from point_dae_torch.models.transformer import ModelDraws
from point_dae_torch.ops import mlp
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, from_flax, to_flax

R, C, H = 512, 128, 512
NAMES = ("dx", "dk1", "db1", "dk2", "db2")


def _mlp_setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(R, C)).astype(np.float32)
    k1 = (rng.normal(size=(C, H)) * 0.05).astype(np.float32)
    b1 = (rng.normal(size=(H,)) * 0.02).astype(np.float32)
    k2 = (rng.normal(size=(H, C)) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=(C,)) * 0.02).astype(np.float32)
    cot = rng.normal(size=(R, C)).astype(np.float32)
    return (x, k1, b1, k2, b2), cot


def _chain(x, k1, b1, k2, b2, dt):
    """The block's plain chain at ``dt``: products, bias and GELU in dt."""
    h = x.astype(dt) @ k1.astype(dt) + b1.astype(dt)
    h = jax.nn.gelu(h, approximate=False)
    return (h.astype(dt) @ k2.astype(dt) + b2.astype(dt)).astype(jnp.float32)


def _jax_value_and_grads(fn, args, cot):
    def loss(*a):
        y = fn(*a)
        return jnp.vdot(y, cot), y
    vg = jax.value_and_grad(loss, argnums=tuple(range(5)), has_aux=True)
    (_, y), g = jax.jit(vg)(*map(jnp.asarray, args))
    return np.asarray(y), [np.asarray(v, np.float32) for v in g]


def test_plain_fused_mlp_matches_jax_kernel():
    """Through the wrappers (f32 primals): the port's plain version and the
    JAX kernel each lie within twice the plain bf16 chain's error of a
    full-f32 oracle (+1e-6 forward, +1e-4 gradients), the bounds of
    tests/test_pallas_mlp.py, and within the same bound of each other. On
    the core's own primals (bf16 x, k1, k2; f32 biases) the two compute the
    same roundings, so their gradients come back in the same types (dx,
    dk1, dk2 bf16; db1, db2 f32) and agree to 2e-3 of each tensor's
    largest value: the JAX kernel's erf is the Abramowitz-Stegun form
    (1.5e-7 off) and its sums run in another order, which can move a bf16
    rounding of the hidden by one step (2^-8) here and there."""
    args, cot = _mlp_setup()
    yo, go = _jax_value_and_grads(functools.partial(_chain, dt=jnp.float32), args, cot)
    yu, gu = _jax_value_and_grads(functools.partial(_chain, dt=jnp.bfloat16), args, cot)
    yk, gk = _jax_value_and_grads(
        lambda *a: pallas_mlp.fused_mlp(*a, interpret=True), args, cot)

    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    yt = mlp.fused_mlp(*ts)
    (yt * torch.from_numpy(cot)).sum().backward()
    assert yt.dtype == torch.float32 and yt.shape == (R, C)
    yt = yt.detach().numpy()

    scale = np.maximum(np.abs(yo), 1e-3)
    err_u = float(np.max(np.abs(yu - yo) / scale))
    for name, y in (("port", yt), ("jax-kernel", yk)):
        assert float(np.max(np.abs(y - yo) / scale)) <= 2 * err_u + 1e-6, name
    assert float(np.max(np.abs(yt - yk) / scale)) <= 2 * err_u + 1e-6
    for name, o, u, k, t in zip(NAMES, go, gu, gk, ts):
        gt = t.grad.numpy()
        sc = float(np.max(np.abs(o))) + 1e-6
        eu = float(np.max(np.abs(u - o))) / sc
        assert float(np.max(np.abs(gt - o))) / sc <= 2 * eu + 1e-4, name
        assert float(np.max(np.abs(gt - k))) / sc <= 2 * eu + 1e-4, name

    # the core: bf16 primals in, gradients in the primals' types
    bf = jnp.bfloat16
    x, k1, b1, k2, b2 = map(jnp.asarray, args)
    prim = (x.astype(bf), k1.astype(bf), b1.reshape(1, H), k2.astype(bf), b2.reshape(1, C))
    yj, vjp = jax.vjp(lambda *p: pallas_mlp._mlp_core(*p, 256, True), *prim)
    gj = vjp(jnp.asarray(cot))
    tp = [torch.from_numpy(a).to(torch.bfloat16 if a.ndim == 2 else torch.float32)
          .requires_grad_() for a in args]
    yc = mlp._MlpPlain.apply(*tp)
    gc = torch.autograd.grad(yc, tp, torch.from_numpy(cot))
    assert [str(g.dtype).split(".")[-1] for g in gc] == [str(g.dtype) for g in gj] == [
        "bfloat16", "bfloat16", "float32", "bfloat16", "float32"]
    assert float(np.max(np.abs(yc.detach().numpy() - np.asarray(yj)))) <= \
        2e-3 * float(np.max(np.abs(np.asarray(yj))))
    for name, a, b in zip(NAMES, gc, gj):
        a, b = a.float().numpy(), np.asarray(b, np.float32).reshape(a.shape)
        assert float(np.max(np.abs(a - b))) <= 2e-3 * float(np.max(np.abs(b))), name


# ----------------------------------------------------------------- the gate

class _TpuJax:
    """``jax`` as the JAX block's gate sees it on a TPU host."""

    class _Dev:
        platform = "tpu"

    def __getattr__(self, name):
        return getattr(jax, name)

    def devices(self, *a):
        return [self._Dev()]


_CASES = [(cd, rd, dp, rows) for cd in ("bf16", "f32") for rd in ("f32", "bf16")
          for dp in ("inert", "stack") for rows in (256, 128)]


@pytest.mark.parametrize("compute,residual,drop_path,rows", _CASES)
def test_block_mlp_dispatch_is_the_jax_gate(monkeypatch, compute, residual, drop_path,
                                            rows):
    """For bf16 or f32 compute, an f32 or bf16 residual stream, inert
    stochastic depth or the stack's masks, and R = B T of 256 (inside
    ``pallas_mlp.supported`` at C 128, H 512) or 128 (outside): the JAX
    block on a TPU and the port's block on a CUDA tensor take the same MLP
    path (``fused_ln``, ``fused`` or ``plain``). Both gates are driven
    without a device: the JAX block through ``jax.eval_shape`` with the
    platform read as a TPU, the port's with ``mlp_route`` read for CUDA;
    the kernels are replaced by recorders."""
    B, T = rows // 32, 32
    seen = {}

    def rec(route, out):
        def fn(*a, **k):
            seen.setdefault("route", route)
            return out(a[0])
        return fn

    monkeypatch.setattr(jlayers, "jax", _TpuJax())
    monkeypatch.setattr(pallas_mlp, "fused_mlp_ln", rec("fused_ln", lambda x: x))
    monkeypatch.setattr(pallas_mlp, "fused_mlp",
                        rec("fused", lambda x: jnp.zeros(x.shape, jnp.float32)))
    jdt = {"bf16": jnp.bfloat16, "f32": None}[compute]
    blk = jlayers.TransformerBlock(C, 2, drop_path_rate=0.1, dtype=jdt)
    x = jax.ShapeDtypeStruct((B, T, C), {"f32": jnp.float32, "bf16": jnp.bfloat16}[residual])
    stack = drop_path == "stack"
    masks = jnp.ones((2, B), bool) if stack else None
    jax.eval_shape(lambda x_: blk.init(jax.random.key(0), x_, deterministic=not stack,
                                       dp_masks=masks), x)
    jax_route = seen.pop("route", "plain")

    real_route = tlayers.mlp_route
    monkeypatch.setattr(tlayers, "mlp_route",
                        lambda cd, dev, xd, *s: real_route(cd, "cuda", xd, *s))
    monkeypatch.setattr(tlayers, "fused_mlp_ln", rec("fused_ln", lambda x: x))
    monkeypatch.setattr(tlayers, "fused_mlp", rec("fused", lambda x: torch.zeros(x.shape)))
    tdt = {"bf16": torch.bfloat16, "f32": None}[compute]
    tblk = tlayers.TransformerBlock(C, 2, drop_path_rate=0.1, dtype=tdt)
    xt = torch.zeros((B, T, C), dtype={"f32": torch.float32, "bf16": torch.bfloat16}[residual])
    with torch.no_grad():
        out = tblk(xt, None, torch.ones((2, B), dtype=torch.bool) if stack else None)
    assert out.dtype == xt.dtype
    assert seen.pop("route", "plain") == jax_route
    expect = "plain" if compute == "f32" or rows == 128 else (
        "fused_ln" if residual == "f32" else "fused")
    assert jax_route == expect
    assert real_route(tdt, "cpu", xt.dtype, B * T, C, H) == "plain"


def test_fused_mlp_refuses_shapes_outside_the_kernel():
    """C 512 is inside ``supported`` (C % 128, H % 128, H >= C) but the
    kernels take C in (128, 256, 384): off the CPU the wrapper raises,
    before anything reaches a plain version."""
    assert mlp.supported(256, 512, 2048)
    x = torch.empty((256, 512), device="meta")
    k1, k2 = torch.empty((512, 2048), device="meta"), torch.empty((2048, 512), device="meta")
    b1, b2 = torch.empty((2048,), device="meta"), torch.empty((512,), device="meta")
    with pytest.raises(ValueError, match="built for"):
        mlp.fused_mlp(x, k1, b1, k2, b2)
    ok = torch.empty((256, 128), device="meta")
    with pytest.raises(ValueError, match="expected one CUDA device"):
        mlp.fused_mlp(ok, torch.empty((128, 512), device="meta"), b1[:512],
                      torch.empty((512, 128), device="meta"), b2[:128])


# ------------------------------------------------- the flagship, both keys

B, NPTS = 4, 128


def _config(**tcfg):
    cfg = _tiny_config()
    cfg["model"]["corrupt_type"] = ["Drop-Patch"]
    cfg["model"]["transformer_config"].update(tcfg)
    return cfg


def _draws(cfg, rng):
    """10 of 16 patches masked a cloud; keep masks of both stacks with
    drops where the rate is nonzero."""
    G = cfg["model"]["num_group"]
    t = cfg["model"]["transformer_config"]
    mask = np.zeros((B, G), bool)
    for b in range(B):
        mask[b, rng.permutation(G)[:10]] = True
    dp_enc = rng.uniform(size=(t["depth"], 2, B)) >= 0.3
    dp_dec = rng.uniform(size=(t["decoder_depth"], 2, B)) >= 0.3
    return mask, dp_enc, dp_dec


def _jax_run(cfg, pts, mask, dp_enc, dp_dec, monkeypatch):
    """Initial weights, the loss, every gradient and the new BatchNorm
    statistics of one train-mode forward of the JAX model."""
    monkeypatch.setattr(jtr, "sample_patch_mask", lambda *a, **k: jnp.asarray(mask))

    def dp_masks(mod, dpr, batch, deterministic):
        if deterministic or max(dpr) == 0.0:
            return None
        return jnp.asarray(dp_enc if len(dpr) == dp_enc.shape[0] else dp_dec)

    monkeypatch.setattr(jlayers, "_stack_dp_masks", dp_masks)
    config = JConfigDict(copy.deepcopy(cfg))
    model = j_build(config["model"])
    params, stats = j_init_model(model, config, jnp.asarray(pts))
    keys = {n: jax.random.key(i) for i, n in enumerate(("corrupt", "mask", "droppath"))}

    def loss_fn(p, x):
        (l1, l2), new = model.apply({"params": p, "batch_stats": stats}, x, x, train=True,
                                    rngs=keys, mutable=["batch_stats"])
        return l1 + l2, (l1, l2, new["batch_stats"])

    (_, (l1, l2, new)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(pts))
    flat = lambda t: _flatten(jax.tree_util.tree_map(np.asarray, t))
    return jax.device_get((params, stats)), (float(l1), float(l2)), flat(grads), flat(new)


def _torch_run(cfg, init, pts, mask, dp_enc, dp_dec):
    model = build_model_from_cfg(ConfigDict(copy.deepcopy(cfg))["model"], device="cpu")
    model.load_state_dict(from_flax(*init), strict=True)
    model.train()
    draws = ModelDraws(torch.from_numpy(mask), None, torch.from_numpy(dp_enc),
                       torch.from_numpy(dp_dec))
    t = torch.from_numpy(pts)
    l1, l2 = model(t, t, draws=draws)
    (l1 + l2).backward()
    l1, l2 = l1.detach(), l2.detach()
    grads = _flatten(to_flax({n: p.grad for n, p in model.named_parameters()
                              if p.grad is not None})[0])
    return (l1.item(), l2.item()), grads, _flatten(to_flax(model.state_dict())[1])


def _gaps(cfg, monkeypatch):
    """(worst relative loss gap, each gradient's gap over the model's
    largest JAX gradient, (port, JAX) BatchNorm statistics), port vs JAX."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(B, NPTS, 3)).astype(np.float32)
    draws = _draws(cfg, rng)
    init, lj, gj, sj = _jax_run(cfg, pts, *draws, monkeypatch)
    lt, gt, st = _torch_run(cfg, init, pts, *draws)
    assert set(gj) == set(gt) and set(sj) == set(st)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lt, lj))
    top = max(float(np.abs(g).max()) for g in gj.values())
    return loss_gap, {k: float(np.abs(gt[k] - gj[k]).max()) / top for k in gj}, (st, sj)


def test_flagship_bf16_residual_matches_jax(monkeypatch):
    """``residual_dtype: bf16`` at bf16 compute, against the JAX model with
    the same weights and draws. bf16 compute alone already parts the two
    frameworks (flax's Dense rounds its product and bias add apart and sums
    a bias gradient in bf16; torch's CPU bf16 ops keep f32 inside each op):
    with an f32 residual stream the folding head's last bias gradient is
    15% of the largest gradient apart. So each gradient is held to its
    f32-residual gap plus 1e-2 of the largest gradient (the bf16 stream
    adds 5e-3 at most here; the key itself moves the JAX model's gradients
    by 8%), the losses to 2e-3 relative (the f32-residual model's are 1e-3
    apart), the BatchNorm statistics (f32 patch embedding) to 1e-4."""
    lb, gb, (st, sj) = _gaps(_config(residual_dtype="bf16"), monkeypatch)
    lf, gf, _ = _gaps(_config(), monkeypatch)
    worst = max(gb, key=lambda k: gb[k] - gf[k])
    print(f"port vs JAX, loss gap: bf16 residual {lb:.2e}, f32 residual {lf:.2e}; "
          f"gradient gap over the f32-residual one, worst {worst}: "
          f"{gb[worst]:.2e} against {gf[worst]:.2e}")
    assert lb <= 2e-3
    for k in gb:
        assert gb[k] <= gf[k] + 1e-2, (k, gb[k], gf[k])
    for k in st:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_embed_all_patches_matches_jax(monkeypatch):
    """``embed_all_patches`` (f32): the losses to 1e-5 relative, the
    gradients within 1e-4 of the model's largest, and the PatchEncoder's
    running statistics after the train-mode forward to 1e-5, all against
    the JAX model. The statistics differ from a run without the key, whose
    BatchNorms see only the visible patches."""
    cfg = _config(embed_all_patches=True)
    del cfg["model"]["transformer_config"]["dtype"]
    lg, gg, (st, sj) = _gaps(cfg, monkeypatch)
    assert lg <= 1e-5 and max(gg.values()) <= 1e-4
    enc = [k for k in st if k.startswith("MAE_encoder/encoder/")]
    assert enc
    for k in enc:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-5, atol=1e-7, err_msg=k)
    cfg_vis = copy.deepcopy(cfg)
    del cfg_vis["model"]["transformer_config"]["embed_all_patches"]
    _, _, (st_vis, _) = _gaps(cfg_vis, monkeypatch)
    assert any(not np.allclose(st[k], st_vis[k]) for k in enc)
