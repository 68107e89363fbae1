"""Port EdgeConv (ops/edgeconv.py, models/dgcnn.py) against the JAX package
on the CPU: the fused kNN-aggregate's plain version against the Pallas
kernels in interpret mode (forward and both backward modes), the fused
layer against ``FusedEdgeConv(interpret=True)``, and the encoder's
implementations against each other on one state dict."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.models import dgcnn as jdg
from point_dae_tpu.ops import pallas_edgeconv as jec

from point_dae_torch.models.dgcnn import DGCNNEncoder, EdgeConv, FusedEdgeConv
from point_dae_torch.ops import edgeconv as tec

from _torch_files import one_torch_thread  # noqa: F401


def _inputs(seed, B, N, C, Cf, duplicates):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(B, N, C)).astype(np.float32)
    xf = rng.normal(size=(B, N, Cf)).astype(np.float32)
    if duplicates:                      # equal points: distance and value ties
        xf[:, N // 2:N // 2 + 8] = xf[:, :8]
        U[:, N // 2:N // 2 + 8] = U[:, :8]
    cot = [rng.normal(size=(B, N, C)).astype(np.float32) for _ in range(4)]
    return U, xf, cot


@pytest.mark.parametrize("grad_mode", ["first", "split"])
@pytest.mark.parametrize("shape,duplicates", [((2, 64, 16, 8, 5), False),
                                              ((3, 128, 24, 3, 6), True)])
def test_knn_aggregate_plain_matches_pallas_interpret(grad_mode, shape, duplicates):
    """Neighbours, max and min equal; sums within 1e-6 and du within 1e-5 of
    the largest magnitude (sums of k, and of a row's contributors, taken in
    another order)."""
    B, N, C, Cf, k = shape
    U, xf, cot = _inputs(0, B, N, C, Cf, duplicates)

    def f(u):
        out = jec.knn_aggregate(u, jnp.asarray(xf), k, min(256, N), True, 3, 3, grad_mode)
        return sum(jnp.vdot(o, c) for o, c in zip(out[:4], cot)), out

    (_, want), gj = jax.value_and_grad(f, has_aux=True)(jnp.asarray(U))
    ut = torch.from_numpy(U).requires_grad_()
    got = tec.knn_aggregate(ut, torch.from_numpy(xf), k, grad_mode)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got[:4], cot)).backward()
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    for i in (0, 1):
        np.testing.assert_array_equal(got[i].detach().numpy(), np.asarray(want[i]))
    for i in (2, 3):
        w = np.asarray(want[i])
        np.testing.assert_allclose(got[i].detach().numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())
    gj = np.asarray(gj)
    np.testing.assert_allclose(ut.grad.numpy(), gj, rtol=0, atol=1e-5 * np.abs(gj).max())
    if duplicates:                      # a duplicated point is its twin's neighbour 0
        assert (got[4][:, N // 2:N // 2 + 8, 0].numpy() == np.arange(8)).all()


def test_knn_aggregate_xla_matches_jax():
    """The gather + reduce aggregates and their autograd gradient (ties
    split evenly, as jnp.max splits them)."""
    U, xf, cot = _inputs(1, 2, 64, 8, 3, True)
    idx = tec.knn_select_plain(torch.from_numpy(xf), 5)
    gj = jax.grad(lambda u: sum(jnp.vdot(o, c) for o, c in zip(
        jec.knn_aggregate_xla(u, jnp.asarray(idx.numpy())), cot)))(jnp.asarray(U))
    ut = torch.from_numpy(U).requires_grad_()
    out = tec.knn_aggregate_xla(ut, idx)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cot)).backward()
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)


def test_supported_follows_jax():
    """The JAX gate without its row-tile test (the CUDA kernel has no row
    tile): equal wherever N is a multiple of the JAX tile, and never closed
    where the JAX gate is open."""
    for N in (40, 100, 128, 200, 250, 256, 300, 512, 1024, 2048, 4096, 8192):
        for k in (1, 2, 20, 64, 65):
            assert tec.supported(N, k) == (2 <= k <= 64 and N <= 4096), (N, k)
            if N % min(256, N) == 0 and min(256, N) % 8 == 0:
                assert tec.supported(N, k) == jec.supported(N, k), (N, k)
            assert tec.supported(N, k) or not jec.supported(N, k), (N, k)
    with pytest.raises(ValueError, match="grad_mode"):
        tec.knn_aggregate(torch.zeros(1, 8, 2), torch.zeros(1, 8, 3), 2, "mean")


def _flax_layer_vars(rng, cin, cout, negative_scale):
    scale = rng.uniform(0.5, 1.5, size=cout).astype(np.float32)
    if negative_scale:
        scale[::2] *= -1.0               # the min branch of the monotone select
    params = {"conv": {"kernel": (rng.normal(size=(2 * cin, cout)) / np.sqrt(2 * cin)
                                  ).astype(np.float32)},
              "bn": {"scale": scale, "bias": rng.normal(size=cout).astype(np.float32) * 0.1}}
    stats = {"bn": {"mean": rng.normal(size=cout).astype(np.float32) * 0.1,
                    "var": rng.uniform(0.5, 1.5, size=cout).astype(np.float32)}}
    return params, stats


def _load_layer(layer, params, stats):
    with torch.no_grad():
        layer.conv.weight.copy_(torch.from_numpy(params["conv"]["kernel"].T))
        layer.bn.weight.copy_(torch.from_numpy(params["bn"]["scale"]))
        layer.bn.bias.copy_(torch.from_numpy(params["bn"]["bias"]))
        layer.bn.running_mean.copy_(torch.from_numpy(stats["bn"]["mean"]))
        layer.bn.running_var.copy_(torch.from_numpy(stats["bn"]["var"]))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("negative_scale", [False, True])
def test_fused_edgeconv_matches_jax_interpret(train, negative_scale):
    """Output, running statistics and the gradients to the input and the
    parameters, f32, rtol 1e-4."""
    rng = np.random.default_rng(2)
    B, N, cin, cout, k = 2, 64, 12, 24, 5
    x = rng.normal(size=(B, N, cin)).astype(np.float32)
    cot = rng.normal(size=(B, N, cout)).astype(np.float32)
    params, stats = _flax_layer_vars(rng, cin, cout, negative_scale)
    jl = jdg.FusedEdgeConv(cout, k, interpret=True)

    def f(p, xx):
        y, mut = jl.apply({"params": p, "batch_stats": stats}, xx, train=train,
                          mutable=["batch_stats"])
        return jnp.vdot(y, cot), (y, mut)

    (_, (yj, mut)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tl = FusedEdgeConv(cin, cout, k, interpret=True)
    _load_layer(tl, params, stats)
    tl.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    yt = tl(xt)
    (yt * torch.from_numpy(cot)).sum().backward()
    close = lambda a, b, what: np.testing.assert_allclose(
        a, np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=what)
    close(yt.detach().numpy(), yj, "output")
    close(xt.grad.numpy(), gx, "dx")
    close(tl.conv.weight.grad.numpy().T, gp["conv"]["kernel"], "dkernel")
    close(tl.bn.weight.grad.numpy(), gp["bn"]["scale"], "dscale")
    close(tl.bn.bias.grad.numpy(), gp["bn"]["bias"], "dbias")
    new = mut["batch_stats"]["bn"] if train else stats["bn"]
    close(tl.bn.running_mean.numpy(), new["mean"], "running mean")
    close(tl.bn.running_var.numpy(), new["var"], "running var")


def test_reference_edgeconv_matches_jax():
    rng = np.random.default_rng(3)
    B, N, cin, cout, k = 2, 64, 6, 16, 4
    x = rng.normal(size=(B, N, cin)).astype(np.float32)
    params, stats = _flax_layer_vars(rng, cin, cout, True)
    yj, mut = jdg.EdgeConv(cout, k).apply({"params": params, "batch_stats": stats}, x,
                                          train=True, mutable=["batch_stats"])
    tl = EdgeConv(cin, cout, k)
    _load_layer(tl, params, stats)
    yt = tl(torch.from_numpy(x))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl.bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["bn"]["var"]), rtol=1e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_encoder_impls_agree_on_one_state_dict(bf16):
    """``fused`` against ``reference`` with the same weights: f32 to 1e-4;
    under bf16 within the 0.05 the JAX package's own test allows (the split
    projections round apart from the edge tensor's). ``auto`` is
    ``reference`` on a CPU tensor, and ``remat`` changes no output."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 64, 3)).astype(np.float32))
    dt = torch.bfloat16 if bf16 else None
    g = torch.Generator().manual_seed(0)
    ref = DGCNNEncoder(k=5, dtype=dt, impl="reference", generator=g)
    sd = ref.state_dict()
    assert "conv1.0.weight" in sd and "bn5.running_var" in sd and len(sd) == 25
    outs = {}
    for impl in ("reference", "fused", "fused_pallas", "auto"):
        enc = DGCNNEncoder(k=5, dtype=dt, impl=impl)
        enc.load_state_dict(sd, strict=True)
        enc.eval()
        with torch.no_grad():
            outs[impl] = enc(x)[0].numpy()
    tol = 0.05 if bf16 else 1e-4
    np.testing.assert_allclose(outs["fused"], outs["reference"], rtol=tol, atol=tol)
    np.testing.assert_array_equal(outs["auto"], outs["reference"])
    np.testing.assert_array_equal(outs["fused_pallas"], outs["fused"])
    remat = DGCNNEncoder(k=5, dtype=dt, impl="reference", remat=True)
    remat.load_state_dict(sd, strict=True)
    remat.eval()
    x_grad = x.clone().requires_grad_()              # grad mode: the checkpoint runs
    np.testing.assert_array_equal(remat(x_grad)[0].detach().numpy(), outs["reference"])


def _gaps(a, b):
    d = np.abs(a - b)
    return float(d.max()), float(d.mean())


def test_bf16_layouts_at_full_width_in_both_packages(monkeypatch):
    """N 1024, k 20, widths 64/64/128/256, batch 2, bf16, train mode, one
    set of weights, the readings behind the limits the on-card check uses:

    - one fused layer tracks one reference layer on the same input within
      the 0.05 (relative and absolute) of the JAX package's own bf16 test,
      at every one of the four layers, with a mean gap under 0.01 (read:
      largest 0.042-0.056, mean 0.002-0.003); with the farthest neighbour
      dropped from the aggregate 2% or more of a layer's elements leave
      that tolerance and the mean gap passes 0.02 (read: 5.3-15.5% and
      0.028-0.048);
    - chained through four kNN graphs the two layouts drift apart by more
      than 1 in single features (mean about 0.1), and they do so alike in
      the JAX package (largest and mean gap within a fifth of each other):
      the drift belongs to the layouts, not to the port;
    - like against like, the port's fused encoder stays within 5% of the
      largest feature of the JAX fused encoder with a mean gap under 0.05
      (read: 0.18 of 9.7, mean 0.007), and a planted fault in the aggregate
      (the farthest neighbour dropped, the sum of squares a twentieth off)
      breaks both limits (read: 2.5-3.4, mean 0.23-0.36)."""
    from point_dae_torch.models import dgcnn as tdg
    from point_dae_torch.utils.convert import to_flax

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2, 1024, 3)).astype(np.float32)
    pts /= np.abs(pts).max()
    x = torch.from_numpy(pts)
    encs = {impl: DGCNNEncoder(k=20, dtype=torch.bfloat16, impl=impl,
                               generator=torch.Generator().manual_seed(0)).train()
            for impl in ("reference", "fused")}
    sd = encs["reference"].state_dict()
    encs["fused"].load_state_dict(sd)
    params, stats = to_flax({"dgcnn_encoder." + k: v for k, v in sd.items()})
    variables = {"params": params["dgcnn_encoder"], "batch_stats": stats["dgcnn_encoder"]}

    plain = tdg.knn_aggregate_plain
    with torch.no_grad():
        h = x
        for i in range(1, 5):
            ref, fus = encs["reference"], encs["fused"]
            want = tdg.edge_conv(h, getattr(ref, f"conv{i}")[0], getattr(ref, f"bn{i}"),
                                 20, torch.bfloat16)
            layer = lambda: tdg.fused_edge_conv(h, getattr(fus, f"conv{i}")[0],
                                                getattr(fus, f"bn{i}"), 20, torch.bfloat16,
                                                interpret=True)
            got = layer()
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0.05, atol=0.05,
                                       err_msg=f"layer {i}")
            assert float((got - want).abs().mean()) <= 0.01, i
            monkeypatch.setattr(tdg, "knn_aggregate_plain",
                                lambda U, xf, k, mode: plain(U, xf, k - 1, mode))
            off = layer()
            monkeypatch.setattr(tdg, "knn_aggregate_plain", plain)
            outside = ~torch.isclose(off, want, rtol=0.05, atol=0.05)
            assert float(outside.float().mean()) > 0.02, i
            assert float((off - want).abs().mean()) > 0.02, i
            h = want
        port = {impl: enc(x)[0].numpy() for impl, enc in encs.items()}
    jax_out = {}
    for impl in ("reference", "fused"):
        enc = jdg.DGCNNEncoder(k=20, dtype=jnp.bfloat16, impl=impl)
        jax_out[impl] = np.asarray(jax.jit(lambda xx, enc=enc: enc.apply(
            variables, xx, train=True, mutable=["batch_stats"])[0][0])(jnp.asarray(pts)))

    top = np.abs(jax_out["fused"]).max()
    port_gap, jax_gap = _gaps(port["fused"], port["reference"]), _gaps(
        jax_out["fused"], jax_out["reference"])
    assert port_gap[0] > 1.0 and jax_gap[0] > 1.0, (port_gap, jax_gap)
    np.testing.assert_allclose(port_gap, jax_gap, rtol=0.2)
    like = _gaps(port["fused"], jax_out["fused"])
    assert like[0] <= 0.05 * top and like[1] <= 0.05, like

    sound = tdg.knn_aggregate_xla
    faults = {"drop_last": lambda U, idx: sound(U, idx[..., :-1]),
              "wrong_s2": lambda U, idx: sound(U, idx)[:3] + (sound(U, idx)[3] * 0.95,)}
    for name, fault in faults.items():
        monkeypatch.setattr(tdg, "knn_aggregate_xla", fault)
        with torch.no_grad():
            off = _gaps(encs["fused"](x)[0].numpy(), jax_out["fused"])
        assert off[0] > 0.05 * top and off[1] > 0.05, (name, off)
