"""The port's CUDA kernels against their plain PyTorch versions on the card.
These need an NVIDIA GPU and skip elsewhere; on a GPU host run them with

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import math

import pytest
import torch

from point_dae_torch.losses import chamfer
from point_dae_torch.ops import attention, folding, gather, mlp, patchify

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def test_patchify_kernel_matches_plain(dev):
    g = _gen(dev)
    pts = torch.randn((4, 1024, 3), generator=g, device=dev)
    pts[0, 7] = 0.0
    fk, kk = patchify.fused_patchify(pts, 64, 32)
    fp, kp = patchify.fused_patchify_plain(pts, 64, 32)
    assert torch.equal(fk, fp)
    center = pts.gather(1, fk.long()[..., None].expand(-1, -1, 3))
    d = ((pts[:, None] - center[:, :, None]) ** 2).sum(-1)
    assert torch.allclose(d.gather(-1, kk.long()), d.gather(-1, kp.long()),
                          rtol=1e-4, atol=1e-4)
    assert float((kk == kp).float().mean()) > 0.9999


def test_gather_kernel_is_exact(dev):
    g = _gen(dev, 1)
    x = torch.randn((4, 1024, 3), generator=g, device=dev)
    idx = torch.randint(0, 1024, (4, 2048), generator=g, device=dev, dtype=torch.int32)
    assert torch.equal(gather.gather_rows_small_c(x, idx),
                       gather.gather_rows_small_c_plain(x, idx))
    idx[0, 0] = 1024                                   # out of range -> zeros
    assert float(gather.gather_rows_small_c(x, idx)[0, 0].abs().sum()) == 0.0


def test_patch_chamfer_kernel_matches_plain(dev):
    g = _gen(dev, 2)
    a = torch.randn((100, 36, 3), generator=g, device=dev)
    b = torch.randn((100, 32, 3), generator=g, device=dev)
    b[5, 9] = b[5, 3]                                  # tie: first index wins
    for x, y in ((a, b), (b, a)):
        dk, ik, nk = chamfer.nn_half_small(x, y)
        dp, ip, np_ = chamfer.nn_half_small_plain(x, y)
        assert torch.equal(ik, ip) and torch.equal(dk, dp) and torch.equal(nk, np_)


@pytest.mark.parametrize("C,scaled", [(384, True), (256, True), (128, False)])
def test_fused_mlp_ln_kernels_match_plain(dev, C, scaled):
    g = _gen(dev, 3)
    R, H = 512, 4 * C
    args = [torch.randn((R, C), generator=g, device=dev),
            1 + 0.1 * torch.randn((C,), generator=g, device=dev),
            0.05 * torch.randn((C,), generator=g, device=dev),
            torch.randn((C, H), generator=g, device=dev) / math.sqrt(C),
            0.02 * torch.randn((H,), generator=g, device=dev),
            torch.randn((H, C), generator=g, device=dev) / math.sqrt(H),
            0.02 * torch.randn((C,), generator=g, device=dev)]
    sc = (torch.rand((R,), generator=g, device=dev) >= 0.1) / 0.9 if scaled else None
    cot = torch.randn((R, C), generator=g, device=dev)
    lk = [t.clone().requires_grad_() for t in args]
    lp = [t.clone().requires_grad_() for t in args]
    yk = mlp.fused_mlp_ln(*lk, row_scale=sc)
    yp = mlp.fused_mlp_ln_plain(*lp, row_scale=sc)
    gk = torch.autograd.grad(yk, lk, cot)
    gp = torch.autograd.grad(yp, lp, cot)

    def rel(a, b):
        a, b = a.detach(), b.detach()
        return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-12)

    assert rel(yk - args[0], yp - args[0]) < 1e-2
    for a, b in zip(gk, gp):
        assert rel(a, b) < 2e-2
    bf = torch.bfloat16
    raw = mlp.mlp_ln_bwd_kernel(args[0], args[1], args[2], args[3].to(bf).contiguous(),
                                args[4], args[5].to(bf).contiguous(), sc, cot)
    assert [t.dtype for t in raw] == [torch.float32] * 3 + [bf, torch.float32, bf,
                                                            torch.float32]


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-12)


@pytest.mark.parametrize("C,tokens", [(128, (2, 32)), (384, (3, 50)), (384, (1, 7))])
def test_fused_folding_kernels_match_plain(dev, C, tokens):
    """Output and all thirteen gradients; 150 and 7 tokens are multiples of
    neither the kernels' token tiles nor the 64-token GEMM tile."""
    g = _gen(dev, 4)
    B, M = tokens
    n = 36
    lin = torch.linspace(-0.3, 0.3, 6, device=dev)
    grid = torch.cartesian_prod(lin, lin)

    def stage(extra):
        def w(i, o):
            return torch.randn((i, o), generator=g, device=dev) / math.sqrt(i)
        return [(w(C + extra, C), 0.05 * torch.randn((C,), generator=g, device=dev)),
                (w(C, C), 0.05 * torch.randn((C,), generator=g, device=dev)),
                (w(C, 3), 0.05 * torch.randn((3,), generator=g, device=dev))]

    x = torch.randn((B, M, C), generator=g, device=dev)
    cot = torch.randn((B, M, n, 3), generator=g, device=dev)
    flat = [x] + [t for st in (stage(2), stage(3)) for pair in st for t in pair]

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in flat]
        p1 = tuple((leaves[1 + 2 * i], leaves[2 + 2 * i]) for i in range(3))
        p2 = tuple((leaves[7 + 2 * i], leaves[8 + 2 * i]) for i in range(3))
        out = fn(leaves[0], grid, p1, p2)
        return out, torch.autograd.grad(out, leaves, cot)

    ok, gk = run(folding.fused_folding)
    op, gp = run(folding.fused_folding_plain)
    torch.cuda.synchronize()
    assert ok.shape == (B, M, n, 3) and ok.dtype == torch.float32
    assert _rel(ok, op) < 1e-2
    for i, (a, b) in enumerate(zip(gk, gp)):
        # 2e-2: bf16 operands, 2^-8 a rounding, summed. A ReLU mask that flips
        # on an f32 sum's last bit switches one cotangent element on or off:
        # at most 1e-4 of the elements may differ by more, up to 1e-1
        err = (a - b).abs() / (float(b.abs().max()) + 1e-12)
        assert a.dtype == torch.float32 and float(err.max()) <= 1e-1, i
        assert float((err > 2e-2).float().mean()) <= 1e-4, i


def test_fused_folding_refuses_shapes_outside_the_kernel(dev):
    """F = 512 passes the gate but not the kernel: it raises."""
    assert folding.supported(512, 512, 36)
    z = lambda *shape: torch.zeros(shape, device=dev)
    stage = lambda e: ((z(512 + e, 512), z(512)), (z(512, 512), z(512)), (z(512, 3), z(3)))
    with pytest.raises(ValueError, match="built for"):
        folding.fused_folding(z(1, 2, 512), z(36, 2), stage(2), stage(3))


@pytest.mark.parametrize("T,masked", [(32, True), (64, False), (64, True), (16, True),
                                      (48, False)])
def test_fused_attention_kernels_match_plain(dev, T, masked):
    g = _gen(dev, 5)
    B, H, d = 7, 6, 64
    qkv = torch.randn((B, T, 3, H, d), generator=g, device=dev)
    cot = torch.randn((B, T, H, d), generator=g, device=dev)
    mask = None
    if masked:
        mask = torch.rand((B, T), generator=g, device=dev) < 0.7
        mask[:, 3] = True

    def run(fn, packed):
        leaf = qkv.clone().requires_grad_()
        q, k, v = leaf.to(torch.bfloat16).unbind(2)
        if not packed:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = fn(q, k, v, mask)
        return out, torch.autograd.grad(out, leaf, cot)[0]

    op, gp = run(attention.fused_attention_plain, True)
    for packed in (True, False):
        ok, gk = run(attention.fused_attention, packed)
        torch.cuda.synchronize()
        assert ok.shape == (B, T, H, d) and ok.dtype == torch.float32
        assert _rel(ok, op) < 1e-2
        for s in range(3):
            assert _rel(gk[:, :, s], gp[:, :, s]) < 2e-2, s
        if masked:
            assert float(gk[:, :, 1:][~mask].abs().max()) == 0.0
    with pytest.raises(ValueError, match="built for"):
        attention.fused_attention(*torch.zeros((3, 2, 8, 2, 32), device=dev))
