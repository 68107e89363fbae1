"""The port's CUDA kernels against their plain PyTorch versions on the card.
These need an NVIDIA GPU and skip elsewhere; on a GPU host run them with

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import math

import pytest
import torch

from point_dae_torch.losses import chamfer
from point_dae_torch.ops import attention, edgeconv, folding, gather, geometry, mlp, patchify
from point_dae_torch.ops import fps as fps_ops
from point_dae_torch.ops import tiled_knn as knn_ops

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


def _lattice(dev, B, N, seed):
    """Integer-lattice points (many equal distances and duplicated points),
    a block of them at the origin (never picked)."""
    g = _gen(dev, seed)
    pts = torch.randint(-4, 5, (B, N, 3), generator=g, device=dev).float()
    pts[:, 10:20] = 0.0
    return pts


@pytest.mark.parametrize("B,N,G,S", [(4, 1024, 64, 32), (2, 2048, 128, 32), (3, 512, 16, 8),
                                     (2, 4096, 32, 16)])
def test_patchify_kernel_is_exact_at_lattice_ties(dev, B, N, G, S):
    """fps_idx and knn_idx equal the plain version's bit for bit on a lattice
    cloud: equal distances go lowest index first; at N 512 and 1024 the
    registers of the rows kernel, at 2048 its largest form, at 4096 the scan
    kernel."""
    pts = _lattice(dev, B, N, 21)
    fk, kk = patchify.fused_patchify(pts, G, S)
    fp, kp = patchify.fused_patchify_plain(pts, G, S)
    torch.cuda.synchronize()
    assert torch.equal(fk, fp) and torch.equal(kk, kp)
    assert torch.equal(fk, fps_ops.fps_kernel(pts, G))


@pytest.mark.parametrize("plan", [(1, 256, 4), (2, 64, 8), (4, 64, 4), (8, 32, 4),
                                  (1, 128, 8), (2, 256, 16)])
def test_patchify_kernel_matches_plain_under_every_fps_plan(dev, plan, monkeypatch):
    """The FPS phase under each form and cluster size: both outputs bit for
    bit the plain version's."""
    pts = _lattice(dev, 3, 1024, 22)
    monkeypatch.setattr(fps_ops, "plan", lambda *a, **k: fps_ops.FpsPlan(*plan))
    fk, kk = patchify.fused_patchify(pts, 32, 16)
    fp, kp = patchify.fused_patchify_plain(pts, 32, 16)
    torch.cuda.synchronize()
    assert torch.equal(fk, fp) and torch.equal(kk, kp)


def test_gather_kernel_is_exact(dev):
    g = _gen(dev, 1)
    x = torch.randn((4, 1024, 3), generator=g, device=dev)
    idx = torch.randint(0, 1024, (4, 2048), generator=g, device=dev, dtype=torch.int32)
    assert torch.equal(gather.gather_rows_small_c(x, idx),
                       gather.gather_rows_small_c_plain(x, idx))
    idx[0, 0] = 1024                                   # out of range -> zeros
    assert float(gather.gather_rows_small_c(x, idx)[0, 0].abs().sum()) == 0.0


@pytest.mark.parametrize("C", [3, 1, 8, 5])
def test_gather_kernel_takes_int64_indices_and_zeros_out_of_range_rows(dev, C):
    """int64 indices read as given, bit for bit the int32 launch and the
    plain version; rows whose index is -1, N or past it come out as zeros,
    at a Q that leaves a ragged last block and unaligned row starts."""
    g = _gen(dev, 12)
    x = torch.randn((3, 1000, C), generator=g, device=dev)
    idx = torch.randint(0, 1000, (3, 1237), generator=g, device=dev)
    got = gather.gather_rows_small_c(x, idx)
    assert torch.equal(got, gather.gather_rows_small_c_plain(x, idx))
    assert torch.equal(got, gather.gather_rows_small_c(x, idx.to(torch.int32)))
    bad = idx.clone()
    bad[0, :3] = torch.tensor([-1, 1000, 5000], device=dev)
    bad[2, -1] = -7
    got = gather.gather_rows_small_c(x, bad)
    assert torch.equal(got, gather.gather_rows_wide_plain(x, bad))
    assert float(got[0, :3].abs().sum()) == 0.0 and float(got[2, -1].abs().sum()) == 0.0


def test_patch_chamfer_kernel_matches_plain(dev):
    g = _gen(dev, 2)
    a = torch.randn((100, 36, 3), generator=g, device=dev)
    b = torch.randn((100, 32, 3), generator=g, device=dev)
    b[5, 9] = b[5, 3]                                  # tie: first index wins
    for x, y in ((a, b), (b, a)):
        dk, ik, nk = chamfer.nn_half_small(x, y)
        dp, ip, np_ = chamfer.nn_half_small_plain(x, y)
        assert torch.equal(ik, ip) and torch.equal(dk, dp) and torch.equal(nk, np_)


BWD_TOL = 5e-3   # see _assert_bwd_close
# A kernel forward against its plain version, over the largest value of the
# MLP branch (mlp_ln: y - x). Both round the hidden (and LN(x)) to bf16 at
# the same points, so what is left is the f32 sum order and erff against
# torch.erf, which can move one bf16 rounding of the hidden by one step: one
# term of a sum of H terms.
FWD_TOL = 5e-3


def _mlp_ln_case(dev, R, C, H, scaled, seed=3):
    """Inputs of ``fused_mlp_ln`` (x, gamma, beta, k1, b1, k2, b2 f32), the
    row scale or None, and a cotangent."""
    g = _gen(dev, seed)
    args = [torch.randn((R, C), generator=g, device=dev),
            1 + 0.1 * torch.randn((C,), generator=g, device=dev),
            0.05 * torch.randn((C,), generator=g, device=dev),
            torch.randn((C, H), generator=g, device=dev) / math.sqrt(C),
            0.02 * torch.randn((H,), generator=g, device=dev),
            torch.randn((H, C), generator=g, device=dev) / math.sqrt(H),
            0.02 * torch.randn((C,), generator=g, device=dev)]
    sc = (torch.rand((R,), generator=g, device=dev) >= 0.1) / 0.9 if scaled else None
    return args, sc, torch.randn((R, C), generator=g, device=dev)


def _mlp_case(dev, R, C, H, seed=30):
    """Inputs of ``fused_mlp`` (x bf16; k1, b1, k2, b2 f32) and a cotangent."""
    g = _gen(dev, seed)
    args = [torch.randn((R, C), generator=g, device=dev).to(torch.bfloat16),
            torch.randn((C, H), generator=g, device=dev) / math.sqrt(C),
            0.02 * torch.randn((H,), generator=g, device=dev),
            torch.randn((H, C), generator=g, device=dev) / math.sqrt(H),
            0.02 * torch.randn((C,), generator=g, device=dev)]
    return args, torch.randn((R, C), generator=g, device=dev)


def _assert_bwd_close(got, want):
    """A kernel backward against its plain twin with ``round_out=False``:
    every output within BWD_TOL of the plain one's largest value. The twin
    rounds where the kernel rounds, so what is left is the f32 sum order,
    the flips of dh's bf16 rounding it causes (one step of one term of a
    sum of C or more), and for the bf16 outputs (dk1, dk2; mlp's dx) their
    own rounding, at most half a step (2^-9 of the value)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel(a, b) < BWD_TOL, (i, _rel(a, b))


@pytest.mark.parametrize("C,scaled", [(384, True), (256, True), (128, False), (512, True),
                                      (768, False)])
def test_fused_mlp_ln_kernels_match_plain(dev, C, scaled):
    """The ``mlp_ln`` kernels at R 512, H 4C: the forward against
    ``fused_mlp_ln_plain`` within FWD_TOL of the branch's largest value, the
    gradients through autograd against ``mlp_ln_bwd_plain`` within BWD_TOL;
    the raw backward gives dk1, dk2 in bf16 and the rest in f32."""
    R, H = 512, 4 * C
    args, sc, cot = _mlp_ln_case(dev, R, C, H, scaled)
    lk = [t.clone().requires_grad_() for t in args]
    yk = mlp.fused_mlp_ln(*lk, row_scale=sc)
    yp = mlp.fused_mlp_ln_plain(*args, row_scale=sc)
    assert _rel(yk - args[0], yp - args[0]) < FWD_TOL
    bf = torch.bfloat16
    k1b, k2b = args[3].to(bf).contiguous(), args[5].to(bf).contiguous()
    want = mlp.mlp_ln_bwd_plain(args[0], args[1], args[2], k1b, args[4], k2b, sc, cot,
                                round_out=False)
    _assert_bwd_close(torch.autograd.grad(yk, lk, cot), want)
    raw = mlp.mlp_ln_bwd_kernel(args[0], args[1], args[2], k1b, args[4], k2b, sc, cot)
    assert [t.dtype for t in raw] == [torch.float32] * 3 + [bf, torch.float32, bf,
                                                            torch.float32]


@pytest.mark.parametrize("C", [384, 128, 256, 512, 768])
def test_fused_mlp_kernels_match_plain(dev, C):
    """The ``mlp`` kernels at R 512, H 4C: the output against
    ``fused_mlp_plain`` within FWD_TOL of its largest value, the gradients
    through autograd against ``mlp_bwd_plain`` within BWD_TOL; the raw
    backward gives dx, dk1, dk2 in bf16 and db1, db2 in f32."""
    R, H = 512, 4 * C
    args, cot = _mlp_case(dev, R, C, H)
    lk = [t.clone().requires_grad_() for t in args]
    yk, yp = mlp.fused_mlp(*lk), mlp.fused_mlp_plain(*args)
    assert yk.dtype == torch.float32 and _rel(yk, yp) < FWD_TOL
    bf = torch.bfloat16
    k1b, k2b = args[1].to(bf).contiguous(), args[3].to(bf).contiguous()
    want = mlp.mlp_bwd_plain(args[0], k1b, args[2], k2b, cot, round_out=False)
    gk = torch.autograd.grad(yk, lk, cot)
    assert [t.dtype for t in gk] == [bf] + [torch.float32] * 4
    _assert_bwd_close(gk, want)
    raw = mlp.mlp_bwd_kernel(args[0], k1b, args[2], k2b, cot)
    assert [t.dtype for t in raw] == [bf, bf, torch.float32, bf, torch.float32]


# (R, C, H) where the engine's 128-wide tiles end in a 64-wide edge (R 192
# and 320; C 320), at C = H, at R 4096 and with one 64-deep k tile (C 64)
EDGE_SHAPES = [(192, 384, 1536), (320, 320, 1280), (512, 384, 384), (4096, 384, 1536),
               (256, 64, 128)]


@pytest.mark.parametrize("R,C,H", EDGE_SHAPES)
@pytest.mark.parametrize("ln", [True, False])
def test_mlp_backwards_match_plain_at_edge_shapes(dev, R, C, H, ln):
    """Both backwards where the 128-wide tiles end in a 64-wide edge (R 192
    and 320; C 320, which also makes dk1's and dk2's tiles ragged; C 64), at
    C = H, and at R 4096 (11 weight slices), against their plain twins
    within BWD_TOL."""
    bf = torch.bfloat16
    if ln:
        args, sc, cot = _mlp_ln_case(dev, R, C, H, True, seed=R + C)
        k1b, k2b = args[3].to(bf).contiguous(), args[5].to(bf).contiguous()
        prim = (args[0], args[1], args[2], k1b, args[4], k2b, sc, cot)
        got, want = mlp.mlp_ln_bwd_kernel(*prim), mlp.mlp_ln_bwd_plain(*prim, round_out=False)
    else:
        args, cot = _mlp_case(dev, R, C, H, seed=R + C)
        prim = (args[0], args[1].to(bf).contiguous(), args[2], args[3].to(bf).contiguous(), cot)
        got, want = mlp.mlp_bwd_kernel(*prim), mlp.mlp_bwd_plain(*prim, round_out=False)
    _assert_bwd_close(got, want)


def _mlp_fwd_call(dev, R, C, H, kind, seed):
    """A forward of ``kind`` (mlp_ln with a row scale, mlp_ln without, mlp)
    at (R, C, H): (kernel call, plain call, the residual the branch is
    measured past)."""
    bf = torch.bfloat16
    if kind == "mlp":
        args, _ = _mlp_case(dev, R, C, H, seed=seed)
        prim = (args[0], args[1].to(bf).contiguous(), args[2], args[3].to(bf).contiguous(),
                args[4])
        return (lambda: mlp.mlp_fwd_kernel(*prim), lambda: mlp.fused_mlp_plain(*args), 0)
    args, sc, _ = _mlp_ln_case(dev, R, C, H, kind == "ln_scaled", seed=seed)
    prim = (args[0], args[1], args[2], args[3].to(bf).contiguous(), args[4],
            args[5].to(bf).contiguous(), args[6], sc)
    return (lambda: mlp.mlp_ln_fwd_kernel(*prim),
            lambda: mlp.fused_mlp_ln_plain(*args, row_scale=sc), args[0])


@pytest.mark.parametrize("R,C,H", EDGE_SHAPES)
@pytest.mark.parametrize("kind", ["ln_scaled", "ln", "mlp"])
def test_mlp_forwards_match_plain_at_edge_shapes(dev, R, C, H, kind):
    """Both forwards where the engine's 128-wide tiles end in a 64-wide edge
    (R 192 and 320, C 320: ragged M and N), at C = H, at R 4096 and with a
    single 64-deep k tile (C 64), against their plain versions within
    FWD_TOL of the branch's largest value."""
    kernel, plain, base = _mlp_fwd_call(dev, R, C, H, kind, seed=R + C + 1)
    got, want = kernel(), plain()
    assert got.dtype == torch.float32 and got.shape == (R, C)
    assert _rel(got - base, want - base) < FWD_TOL


def test_mlp_forwards_repeat_bit_for_bit_in_one_launch_count(dev):
    """Two calls of each forward on the same inputs give the same bits, and
    each call counts one launch of its wrapper (its two or three launches
    count as one)."""
    from point_dae_torch.utils import kernels

    ln, _, _ = _mlp_fwd_call(dev, 4096, 384, 1536, "ln_scaled", seed=7)
    mf, _, _ = _mlp_fwd_call(dev, 4096, 384, 1536, "mlp", seed=8)
    kernels.reset_launches()
    a, b, c, d = ln(), ln(), mf(), mf()
    assert (kernels.launches["mlp_ln_fwd"], kernels.launches["mlp_fwd"]) == (2, 2)
    assert torch.equal(a, b) and torch.equal(c, d)


def test_mlp_forwards_raise_on_unaligned_inputs(dev):
    """The forwards' cp.async copies read 16-byte vectors: an input that does
    not start on 16 bytes raises instead of launching."""
    bf = torch.bfloat16
    args, sc, _ = _mlp_ln_case(dev, 256, 128, 512, True)
    k1b, k2b = args[3].to(bf).contiguous(), args[5].to(bf).contiguous()
    x = torch.empty(256 * 128 + 2, device=dev)[2:].view(256, 128).copy_(args[0])
    with pytest.raises(ValueError, match="16-byte"):
        mlp.mlp_ln_fwd_kernel(x, args[1], args[2], k1b, args[4], k2b, args[6], sc)
    xb = torch.empty(256 * 128 + 4, dtype=bf, device=dev)[4:].view(256, 128)
    with pytest.raises(ValueError, match="16-byte"):
        mlp.mlp_fwd_kernel(xb, k1b, args[4], k2b, args[6])


def test_mlp_backwards_repeat_bit_for_bit_in_one_launch_count(dev):
    """Two calls of each backward on the same inputs give the same bits (no
    atomics; every partial has one owner and one order), and each call
    counts one launch of its wrapper."""
    from point_dae_torch.utils import kernels

    bf = torch.bfloat16
    args, sc, cot = _mlp_ln_case(dev, 4096, 384, 1536, True, seed=5)
    prim = (args[0], args[1], args[2], args[3].to(bf).contiguous(), args[4],
            args[5].to(bf).contiguous(), sc, cot)
    margs, mcot = _mlp_case(dev, 4096, 384, 1536, seed=6)
    mprim = (margs[0], margs[1].to(bf).contiguous(), margs[2], margs[3].to(bf).contiguous(),
             mcot)
    kernels.reset_launches()
    a, b = mlp.mlp_ln_bwd_kernel(*prim), mlp.mlp_ln_bwd_kernel(*prim)
    c, d = mlp.mlp_bwd_kernel(*mprim), mlp.mlp_bwd_kernel(*mprim)
    assert (kernels.launches["mlp_ln_bwd"], kernels.launches["mlp_bwd"]) == (2, 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(c, d))


@pytest.mark.parametrize("a_mn,b_mn", [(False, False), (False, True), (True, False),
                                       (True, True)])
def test_mlp_bwd_engine_product_of_each_layout_matches_matmul(dev, a_mn, b_mn):
    """One product of the backward's wgmma engine (``csrc/mlp.cu:
    mlp_bwd_check``) for each operand layout, K-major or MN-major A and B,
    at M 192, N 320 (edge tiles of 64), K 256, against the same product of
    the bf16 operands in f32 (sum order alone: 1e-5 of the largest value)."""
    import ctypes

    from point_dae_torch.utils import kernels

    M, N, K = 192, 320, 256
    g = _gen(dev, 40)
    a = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((K, N), generator=g, device=dev).to(torch.bfloat16)
    a_in = (a.t() if a_mn else a).contiguous()
    b_in = (b if b_mn else b.t()).contiguous()
    out = torch.empty((M, N), device=dev)
    fn = kernels.library("mlp").mlp_bwd_check
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, I, I, P]
    fn.restype = I
    assert fn(a_in.data_ptr(), b_in.data_ptr(), out.data_ptr(), int(a_mn), int(b_mn), M, N, K,
              kernels.stream(a)) == 0
    torch.cuda.synchronize()
    assert _rel(out, a.float() @ b.float()) < 1e-5


def test_bf16_residual_block_takes_the_mlp_kernels(dev):
    """A bf16-compute block on a bf16 residual stream at R = 8 x 32 = 256,
    C 128 launches ``mlp_fwd`` and ``mlp_bwd`` once each and no ``mlp_ln``;
    on an f32 stream it takes ``mlp_ln`` instead."""
    from point_dae_torch.models.layers import TransformerBlock
    from point_dae_torch.utils import kernels

    blk = TransformerBlock(128, 2, drop_path_rate=0.1, dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.randn((8, 32, 128), generator=_gen(dev, 31), device=dev)
    masks = torch.ones((2, 8), dtype=torch.bool, device=dev)
    kernels.reset_launches()
    y = blk(x.to(torch.bfloat16).requires_grad_(), None, masks)
    y.float().sum().backward()
    assert y.dtype == torch.bfloat16
    assert (kernels.launches["mlp_fwd"], kernels.launches["mlp_bwd"],
            kernels.launches["mlp_ln_fwd"]) == (1, 1, 0)
    kernels.reset_launches()
    blk(x, None, masks).sum().backward()
    assert (kernels.launches["mlp_fwd"], kernels.launches["mlp_ln_fwd"],
            kernels.launches["mlp_ln_bwd"]) == (0, 1, 1)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("C", [64, 5, 8, 384])
def test_wide_gather_kernel_is_exact(dev, dtype, C, idx_dtype):
    """``gather_rows_wide`` against its plain version and ``torch.gather``,
    bit for bit, from int32 and int64 indices read as given (C 64, 8 and
    384 take the 16-byte loads where the row type allows, C 5 the scalar
    ones); indices outside [0, N) give zero rows."""
    g = _gen(dev, 32)
    x = torch.randn((4, 2048, C), generator=g, device=dev).to(dtype)
    idx = torch.randint(0, 2048, (4, 3001), generator=g, device=dev).to(idx_dtype)
    got = gather.gather_rows_wide(x, idx)
    assert got.dtype == torch.float32
    assert torch.equal(got, gather.gather_rows_wide_plain(x, idx))
    assert torch.equal(got, torch.gather(x.float(), 1,
                                         idx.long()[..., None].expand(-1, -1, C)))
    idx[1, 5], idx[2, 0], idx[3, 3000] = -3, 2048, 2 ** 31 - 1
    got = gather.gather_rows_wide(x, idx)
    assert not got[1, 5].any() and not got[2, 0].any() and not got[3, 3000].any()
    assert torch.equal(got, gather.gather_rows_wide_plain(x, idx))


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-12)


def _folding_case(dev, C, F, tokens, n=36, seed=4):
    g = _gen(dev, seed)
    B, M = tokens
    side = int(math.isqrt(n))
    lin = torch.linspace(-0.3, 0.3, side, device=dev)
    grid = torch.cartesian_prod(lin, lin)[:n]
    if grid.shape[0] < n:
        grid = torch.cat([grid, 0.1 * torch.randn((n - grid.shape[0], 2), generator=g,
                                                  device=dev)])

    def stage(extra):
        def w(i, o):
            return torch.randn((i, o), generator=g, device=dev) / math.sqrt(i)
        return [(w(C + extra, F), 0.05 * torch.randn((F,), generator=g, device=dev)),
                (w(F, F), 0.05 * torch.randn((F,), generator=g, device=dev)),
                (w(F, 3), 0.05 * torch.randn((3,), generator=g, device=dev))]

    x = torch.randn((B, M, C), generator=g, device=dev)
    cot = torch.randn((B, M, n, 3), generator=g, device=dev)
    flat = [x] + [t for st in (stage(2), stage(3)) for pair in st for t in pair]

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in flat]
        p1 = tuple((leaves[1 + 2 * i], leaves[2 + 2 * i]) for i in range(3))
        p2 = tuple((leaves[7 + 2 * i], leaves[8 + 2 * i]) for i in range(3))
        out = fn(leaves[0], grid, p1, p2)
        return out, torch.autograd.grad(out, leaves, cot)

    return run


def _assert_folding_close(ok, gk, op, gp):
    assert ok.dtype == torch.float32
    assert _rel(ok, op) < 1e-2
    for i, (a, b) in enumerate(zip(gk, gp)):
        # 2e-2: bf16 operands, 2^-8 a rounding, summed. A ReLU mask that flips
        # on an f32 sum's last bit switches one cotangent element on or off:
        # at most 1e-4 of the elements may differ by more, up to 1e-1
        err = (a - b).abs() / (float(b.abs().max()) + 1e-12)
        assert a.dtype == torch.float32 and float(err.max()) <= 1e-1, i
        assert float((err > 2e-2).float().mean()) <= 1e-4, i


@pytest.mark.parametrize("C,tokens,n", [(128, (2, 32), 36), (384, (3, 50), 36),
                                        (384, (1, 7), 36), (256, (2, 9), 64),
                                        (128, (2, 9), 2), (128, (1, 5), 20)])
def test_fused_folding_kernels_match_plain(dev, C, tokens, n):
    """Output and all thirteen gradients; 150, 18 and 7 tokens are multiples
    of neither the kernels' token tiles nor the 64-token GEMM tile, and n 64,
    2 and 20 give tiles of 2 and 8 tokens with padded rows."""
    run = _folding_case(dev, C, C, tokens, n)
    ok, gk = run(folding.fused_folding)
    op, gp = run(folding.fused_folding_plain)
    torch.cuda.synchronize()
    assert ok.shape == (tokens[0], tokens[1], n, 3)
    _assert_folding_close(ok, gk, op, gp)


@pytest.mark.parametrize("C,F", [(512, 512), (384, 512), (256, 640), (128, 1024)])
def test_fused_folding_takes_every_width_of_the_gate(dev, C, F):
    """F 512 (the widest one-block form) and F 640 and 1024 (the wide form)
    run on the kernels and match the plain version under the same bound."""
    from point_dae_torch.utils import kernels

    assert folding.supported(C, F, 36) and folding.kernel_takes(C, F, 36)
    run = _folding_case(dev, C, F, (2, 40), 36, seed=7)
    kernels.reset_launches()
    ok, gk = run(folding.fused_folding)
    assert (kernels.launches["folding_fwd"], kernels.launches["folding_bwd"]) == (1, 1)
    op, gp = run(folding.fused_folding_plain)
    torch.cuda.synchronize()
    _assert_folding_close(ok, gk, op, gp)


@pytest.mark.parametrize("F", [384, 640])
def test_fused_folding_backward_repeats_bit_for_bit(dev, F):
    """Two backward calls on the same inputs agree bit for bit: no atomics,
    every partial sum in a fixed order."""
    run = _folding_case(dev, F, F, (4, 33), 36, seed=9)
    _, first = run(folding.fused_folding)
    _, second = run(folding.fused_folding)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
    small = torch.randn((3, 2, 8, 2, 32), generator=g, device=dev)   # T 8, d 32
    assert attention.supported(2, 8, 2, 32)
    assert _rel(attention.fused_attention(*small), attention.fused_attention_plain(*small)) < 1e-2


@pytest.mark.parametrize("B,T,H,d,masked", [(16, 40, 4, 32, True), (8, 128, 4, 64, False),
                                            (2, 256, 4, 128, False), (4, 24, 2, 32, True),
                                            (4, 100, 2, 64, True), (2, 64, 1, 256, False),
                                            (1, 1024, 2, 64, True), (8, 2, 2, 64, True),
                                            (4, 16, 3, 8, True), (2, 72, 2, 200, True)])
def test_fused_attention_at_gate_shapes_matches_plain(dev, B, T, H, d, masked):
    """Shapes inside the gate beyond the models': T not a multiple of 16,
    T past 64 (the streamed forward and the two-launch backward), d 32, 128
    and 256 (padded to the kernels' widths); the output within 1e-2 and
    dq, dk, dv within 2e-2 of the plain version, exact zeros on invalid
    keys."""
    assert attention.supported(B, T, H, d)
    g = _gen(dev, 13)
    qkv = torch.randn((B, T, 3, H, d), generator=g, device=dev)
    cot = torch.randn((B, T, H, d), generator=g, device=dev)
    mask = None
    if masked:
        mask = torch.rand((B, T), generator=g, device=dev) < 0.6
        mask[:, 1] = True

    def run(fn):
        leaf = qkv.clone().requires_grad_()
        q, k, v = leaf.to(torch.bfloat16).unbind(2)
        out = fn(q, k, v, mask)
        return out, torch.autograd.grad(out, leaf, cot)[0]

    op, gp = run(attention.fused_attention_plain)
    ok, gk = run(attention.fused_attention)
    torch.cuda.synchronize()
    assert ok.shape == (B, T, H, d) and _rel(ok, op) < 1e-2
    for s in range(3):
        assert _rel(gk[:, :, s], gp[:, :, s]) < 2e-2, s
    if masked:
        assert float(gk[:, :, 1:][~mask].abs().max()) == 0.0


def test_tiled_chamfer_kernel_matches_plain(dev):
    """Bit for bit, both directions, at sizes that are multiples of neither
    the row block nor the y tile; a duplicated target resolves to the first."""
    g = _gen(dev, 6)
    a = torch.randn((3, 700, 3), generator=g, device=dev)
    b = torch.randn((3, 1500, 3), generator=g, device=dev)
    b[1, 1200] = b[1, 37]
    a[2, 5] = b[2, 9]                                  # a zero distance
    for x, y in ((a, b), (b, a)):
        dk, ik = chamfer.nn_half_tiled(x, y)
        dp, ip = chamfer.nn_half_tiled_plain(x, y)
        assert torch.equal(ik, ip) and torch.equal(dk, dp)
        assert float(dk.min()) >= 0.0
    assert chamfer.use_tiled_kernel(a, 1500) and not chamfer.use_small_kernel(a, 1500)
    d1, d2, i1, i2 = chamfer.nn_distance(a, b)
    assert torch.equal(i1, chamfer.nn_half_tiled_plain(a, b)[1])
    with pytest.raises(ValueError, match="built for"):
        chamfer.nn_half_tiled(torch.zeros((1, 600, 2), device=dev),
                              torch.zeros((1, 600, 2), device=dev))


@pytest.mark.parametrize("N,Cf,C,k", [(1024, 3, 64, 20), (512, 64, 256, 20),
                                      (200, 24, 64, 20), (40, 5, 48, 7),
                                      (256, 128, 256, 40), (96, 30, 30, 20),
                                      (1000, 70, 130, 33)])
def test_knn_aggregate_kernels_match_plain(dev, N, Cf, C, k):
    """Forward bit for bit (neighbours, max, min, sums in round order, first
    rounds); du of both backward kernels within 1e-5 of the plain version's
    largest magnitude (the plain version sums a row's contributions in
    another order) and identical bits on a second run. U holds bf16 values
    and some points are duplicated, so distances and values tie."""
    g = _gen(dev, 7)
    B = 3
    assert edgeconv.supported(N, k)
    xf = torch.randn((B, N, Cf), generator=g, device=dev)
    U = torch.randn((B, N, C), generator=g, device=dev).bfloat16().float()
    xf[:, N // 2:N // 2 + 10] = xf[:, :10]
    U[:, N // 2:N // 2 + 10] = U[:, :10]
    cots = [torch.randn((B, N, C), generator=g, device=dev) for _ in range(4)]
    outk = edgeconv.knn_aggregate_fwd_kernel(U, xf, k, True)
    idx = edgeconv.knn_select_plain(xf, k)
    outp = edgeconv.aggregate_plain(U, idx)
    torch.cuda.synchronize()
    assert torch.equal(outk[4], idx)
    for a, b in zip(outk[:4] + outk[5:], outp):
        assert torch.equal(a.to(b.dtype), b)
    assert torch.equal(idx[:, :10, 0], torch.arange(10, device=dev).expand(B, -1))
    for mode in ("first", "split"):
        lk = U.clone().requires_grad_()
        lp = U.clone().requires_grad_()
        ok = edgeconv.knn_aggregate(lk, xf, k, mode)
        op = edgeconv.knn_aggregate_plain(lp, xf, k, mode)
        gk = torch.autograd.grad(ok[:4], lk, cots, retain_graph=True)[0]
        gk2 = torch.autograd.grad(ok[:4], lk, cots)[0]
        gp = torch.autograd.grad(op[:4], lp, cots)[0]
        assert _rel(gk, gp) < 1e-5, mode
        assert torch.equal(gk, gk2), mode


def test_shapes_inside_a_gate_without_a_kernel_raise(dev):
    """Every shape inside the three gates that used to raise for want of a
    kernel now launches one: the EdgeConv kernel at N 2048, the kNN kernel
    at (1024, 1024), the key gather for a masked resample (2048 -> 1024)."""
    from point_dae_torch.utils import kernels

    z = lambda *shape: torch.zeros(shape, device=dev)
    before = dict(kernels.launches)
    assert edgeconv.supported(2048, 20)
    edgeconv.knn_aggregate(z(1, 2048, 8), torch.randn((1, 2048, 3), device=dev), 20)
    geometry.knn(torch.randn((1, 1024, 3), device=dev), torch.randn((1, 1024, 3), device=dev), 20)
    geometry.resample_batch(torch.randn((64, 2048, 3), device=dev),
                            torch.ones((64, 2048), dtype=torch.bool, device=dev), 1024)
    for name in ("knn_aggregate_fwd", "knn", "key_gather"):
        assert kernels.launches[name] == before[name] + 1, name


@pytest.mark.parametrize("B,N,C,k", [(4, 2048, 64, 20), (2, 4096, 64, 20), (2, 1100, 5, 7)])
def test_knn_aggregate_above_1024_points_is_exact(dev, B, N, C, k):
    """The streamed selection and the backwards sized by N: neighbours and
    the four aggregates bit for bit with the plain version, both backwards
    bit for bit with the plain version on the CPU (each sum in (i, r)
    order), duplicated points included."""
    g = _gen(dev, 11)
    xf = torch.randn((B, N, 3 if C == 5 else 64), generator=g, device=dev)
    xf[:, N - 40:N - 8] = xf[:, :32]
    U = torch.randn((B, N, C), generator=g, device=dev)
    U[:, N - 40:N - 8] = U[:, :32]
    cots = [torch.randn((B, N, C), generator=g, device=dev) for _ in range(4)]
    M, m, S1, S2, idx, rM, rm = edgeconv.knn_aggregate_fwd_kernel(U, xf, k, True)
    want_idx = edgeconv.knn_select_plain(xf, k)
    assert torch.equal(idx, want_idx)
    for a, b in zip((M, m, S1, S2, rM, rm), edgeconv.aggregate_plain(U, want_idx)):
        assert torch.equal(a.to(b.dtype), b)
    cpu = [t.cpu() for t in cots]
    for mode, a, c, plain in (("first", rM, rm, edgeconv.bwd_first_plain),
                              ("split", M, m, edgeconv.bwd_split_plain)):
        du = edgeconv.knn_aggregate_bwd_kernel(mode, U, idx, a, c, *cots)
        want = plain(U.cpu(), idx.cpu(), a.cpu(), c.cpu(), *cpu)
        assert torch.equal(du.cpu(), want), mode


# (B, N, Cf, C): the smallest DGCNN cloud, a cloud off the 32-column grid,
# the ScanObjectNN fine-tune's clouds, the gate's largest N
GATE_SHAPES = [(2, 1024, 64, 64), (3, 1000, 3, 64), (32, 2048, 64, 64), (4, 4096, 64, 64)]


@pytest.mark.parametrize("B,N,Cf,C", GATE_SHAPES)
def test_knn_select_matches_plain_at_gate_shapes(dev, B, N, Cf, C):
    """The redesigned selection (distances staged in shared memory, then
    the rounds): idx equal to the plain version's, duplicated rows
    included; the forward's aggregates bit for bit."""
    g = _gen(dev, 41)
    xf = torch.randn((B, N, Cf), generator=g, device=dev)
    xf[:, N - 48:] = xf[:, :48]
    U = torch.randn((B, N, C), generator=g, device=dev).bfloat16().float()
    M, m, S1, S2, idx, rM, rm = edgeconv.knn_aggregate_fwd_kernel(U, xf, 20, True)
    want = edgeconv.knn_select_plain(xf, 20)
    assert torch.equal(idx, want)
    for a, b in zip((M, m, S1, S2, rM, rm), edgeconv.aggregate_plain(U, want)):
        assert torch.equal(a.to(b.dtype), b)


@pytest.mark.parametrize("B,N,Cf,C", GATE_SHAPES + [(2, 1000, 3, 48), (2, 700, 5, 130),
                                                    (2, 500, 3, 33)])
def test_knn_aggregate_backwards_at_gate_shapes(dev, B, N, Cf, C):
    """Both backwards (counting sort, then the ordered sums) within 1e-5 of
    the plain version's largest magnitude on the card (scatter_add_'s
    atomics add in another order), bit for bit with it on the CPU (each sum
    in (i, r) order) and with a second call; C 48 leaves lanes idle, C 130
    takes three channel slices, C 33 one channel a lane."""
    g = _gen(dev, 42)
    xf = torch.randn((B, N, Cf), generator=g, device=dev)
    xf[:, N - 48:] = xf[:, :48]
    U = torch.randn((B, N, C), generator=g, device=dev).bfloat16().float()
    U[:, N - 48:] = U[:, :48]
    cots = [torch.randn((B, N, C), generator=g, device=dev) for _ in range(4)]
    M, m, _, _, idx, rM, rm = edgeconv.knn_aggregate_fwd_kernel(U, xf, 20, True)
    for mode, a, c, plain in (("first", rM, rm, edgeconv.bwd_first_plain),
                              ("split", M, m, edgeconv.bwd_split_plain)):
        du = edgeconv.knn_aggregate_bwd_kernel(mode, U, idx, a, c, *cots)
        again = edgeconv.knn_aggregate_bwd_kernel(mode, U, idx, a, c, *cots)
        assert torch.equal(du, again), mode
        assert _rel(du, plain(U, idx, a, c, *cots)) < 1e-5, mode
        want = plain(U.cpu(), idx.cpu(), a.cpu(), c.cpu(), *[t.cpu() for t in cots])
        assert torch.equal(du.cpu(), want), mode


@pytest.mark.parametrize("B,N,k", [(2, 1024, 20), (3, 1000, 20), (4, 4096, 20), (2, 300, 64),
                                   (2, 96, 7)])
def test_contributor_lists_kernel_matches_plain(dev, B, N, k):
    """The backward's counting sort alone (the library's check entry): list
    starts and entries equal to ``contributor_lists_plain``'s, a hub row
    named by every row included."""
    g = _gen(dev, 43)
    xf = torch.randn((B, N, 16), generator=g, device=dev)
    xf[:, N // 2:] = xf[:, :1]                          # half the cloud on one point
    idx = edgeconv.knn_select_plain(xf, k)
    start, entries = edgeconv.contributor_lists_kernel(idx)
    want_start, want_entries = edgeconv.contributor_lists_plain(idx.cpu())
    assert torch.equal(start.cpu(), want_start)
    assert torch.equal(entries.cpu(), want_entries)


def test_knn_kernel_matches_plain(dev):
    """The MaskFeat shapes, small: 64 queries in 1024 points (k 32) and a
    cloud in itself at C 64 (k 20). idx equal, dists bit for bit."""
    g = _gen(dev, 12)
    pts = torch.randn((4, 1024, 3), generator=g, device=dev)
    pts[:, 600:610] = pts[:, :10]
    feat = torch.randn((2, 1024, 64), generator=g, device=dev)
    for q, y, k in ((pts[:, :64], pts, 32), (feat, feat, 20)):
        dk, ik = knn_ops.knn_kernel(q, y, k)
        dp, ip = knn_ops.knn_plain(q, y, k)
        assert torch.equal(ik, ip) and torch.equal(dk, dp)


def test_key_gather_and_aggregate_from_idx_kernels_are_exact(dev):
    """The key gather at the dropout shape (B 64, 2048 -> 1024) with a row of
    no valid point (zeros); aggregate_from_idx bit for bit with its plain
    version and equal to knn_aggregate's aggregates over the same idx."""
    g = _gen(dev, 13)
    x = torch.randn((64, 2048, 3), generator=g, device=dev)
    mask = torch.rand((64, 2048), generator=g, device=dev) > 0.5
    mask[3] = False
    keys = torch.where(mask, torch.cumsum(mask.int(), 1) - 1, -1)
    cnt = mask.sum(1).clamp_min(1)
    draw = (torch.rand((64, 1024), generator=g, device=dev) * cnt[:, None]).long()
    got = gather.gather_by_key(x, keys, draw)
    assert torch.equal(got, gather.gather_by_key_plain(x, keys, draw))
    assert not got[3].any()
    U = torch.randn((4, 1024, 64), generator=g, device=dev)
    xf = torch.randn((4, 1024, 3), generator=g, device=dev)
    idx = edgeconv.knn_select_plain(xf, 20)
    out = edgeconv.aggregate_fwd_kernel(U, idx, True)
    for a, b in zip(out, edgeconv.aggregate_plain(U, idx)):
        assert torch.equal(a.to(b.dtype), b)
    fused = edgeconv.knn_aggregate_fwd_kernel(U, xf, 20, True)
    assert all(torch.equal(a, b) for a, b in zip(out[:4], fused[:4]))


def _key_gather_case(dev, B, N, Q, C, seed):
    """Clouds of N points with a random mask: cloud 0 with no valid point,
    cloud 1 all valid, cloud 2 with one; uniforms with some just under 1.0
    and at 0; the ranks they give and, in cloud 1, ranks past the count."""
    g = _gen(dev, seed)
    x = torch.randn((B, N, C), generator=g, device=dev)
    mask = torch.rand((B, N), generator=g, device=dev) > 0.5
    mask[0] = False
    mask[1] = True
    mask[2] = False
    mask[2, N // 2] = True
    u = torch.rand((B, Q), generator=g, device=dev)
    u[:, :3] = 1.0 - 2.0 ** -24
    u[:, 3] = 0.0
    ranks = gather.ranks_from_uniforms(mask, u)
    past = ranks.clone()
    past[1, :5] = N + torch.arange(5, device=dev)
    return x, mask, u, ranks, past


@pytest.mark.parametrize("N", [1, 31, 1000, 2048, 12288])
@pytest.mark.parametrize("draws", ["int32", "int64", "f32"])
def test_key_gather_from_mask_is_exact(dev, N, draws):
    """Form (b), the mask and the draws as given: bit for bit with
    ``gather_by_mask_plain`` at Q 777 (no multiple of a block's draws), the
    cloud with no valid point all zeros, the same bits on a second launch,
    one launch counted."""
    from point_dae_torch.utils import kernels

    x, mask, u, ranks, _ = _key_gather_case(dev, 4, N, 777, 3, 31)
    d = {"int32": ranks.int(), "int64": ranks, "f32": u}[draws]
    before = kernels.launches["key_gather"]
    got = gather.gather_by_mask(x, mask, d)
    again = gather.gather_by_mask(x, mask, d)
    torch.cuda.synchronize()
    assert kernels.launches["key_gather"] == before + 2
    assert torch.equal(got, gather.gather_by_mask_plain(x, mask, d))
    assert torch.equal(got, again)
    assert not got[0].any() and got[1].any()


@pytest.mark.parametrize("N", [1, 31, 1000, 2048, 12288])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_key_gather_from_keys_is_exact(dev, N, dtype):
    """Form (a), keys and ranks as given (int32 or int64): bit for bit with
    ``gather_by_key_plain``, ranks past the count giving zeros, the cloud
    with no valid point all zeros, the same bits on a second launch."""
    x, mask, _, _, past = _key_gather_case(dev, 4, N, 777, 3, 32)
    keys = torch.where(mask, torch.cumsum(mask.int(), 1) - 1, -1).to(dtype)
    d = past.to(dtype)
    got = gather.gather_by_key(x, keys, d)
    again = gather.gather_by_key(x, keys, d)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.gather_by_key_plain(x, keys, d))
    assert torch.equal(got, again)
    assert not got[0].any() and not got[1, :5].any()


@pytest.mark.parametrize("threads", [128, 256, 512, 1024])
@pytest.mark.parametrize("N,C", [(2048, 3), (1000, 1), (12288, 8)])
def test_key_gather_is_exact_at_every_block_width(dev, threads, N, C):
    """Both forms in blocks of 128 to 1024 threads, with more draws than a
    block's threads (several passes) and several mask rounds a block:
    bit for bit with the plain twins."""
    x, mask, u, _, past = _key_gather_case(dev, 3, N, 1500, C, 33)
    keys = torch.where(mask, torch.cumsum(mask.int(), 1) - 1, -1)
    got_b = gather.gather_by_mask(x, mask, u, threads=threads)
    got_a = gather.gather_by_key(x, keys, past, threads=threads)
    torch.cuda.synchronize()
    assert torch.equal(got_b, gather.gather_by_mask_plain(x, mask, u))
    assert torch.equal(got_a, gather.gather_by_key_plain(x, keys, past))


def test_key_gather_takes_unaligned_inputs(dev):
    """A mask that starts one byte in and rows that start one float in (so a
    row's 8-byte half sits at the other end): both forms give the same bits
    as their plain twins."""
    x, mask, u, ranks, _ = _key_gather_case(dev, 4, 2049, 600, 3, 34)
    m = mask[:, 1:]
    xo = torch.empty(x[:, 1:].numel() + 1, device=dev)[1:].view(4, 2048, 3)
    xo.copy_(x[:, 1:])
    assert xo.is_contiguous() and xo.data_ptr() % 8 == 4
    got = gather.gather_by_mask(xo, m, u)
    assert torch.equal(got, gather.gather_by_mask_plain(xo, m, u))
    keys = torch.where(m, torch.cumsum(m.int(), 1) - 1, -1)
    r = gather.ranks_from_uniforms(m, u)
    assert torch.equal(gather.gather_by_key(xo, keys, r), gather.gather_by_key_plain(xo, keys, r))


def test_key_gather_refuses_what_it_does_not_take(dev):
    """C 9, N 12289 and a non-f32 x raise in the wrapper, as do float draws
    for given keys and f64 uniforms for a mask."""
    mask = torch.ones((2, 64), dtype=torch.bool, device=dev)
    u = torch.rand((2, 16), device=dev)
    with pytest.raises(ValueError):
        gather.gather_by_mask(torch.zeros((2, 64, 9), device=dev), mask, u)
    with pytest.raises(ValueError):
        gather.gather_by_mask(torch.zeros((2, 12289, 3), device=dev),
                              torch.ones((2, 12289), dtype=torch.bool, device=dev), u)
    with pytest.raises(ValueError):
        gather.gather_by_mask(torch.zeros((2, 64, 3), dtype=torch.float16, device=dev), mask, u)
    with pytest.raises(ValueError):
        gather.gather_by_key(torch.zeros((2, 64, 3), device=dev), mask.long(), u)
    with pytest.raises(ValueError):
        gather.gather_by_mask(torch.zeros((2, 64, 3), device=dev), mask, u.double())


def test_masked_resample_is_one_launch(dev):
    """Inside the JAX gate a masked ``resample_batch`` is one kernel launch
    from the mask and the f32 draws: the key gather's counter rises by one a
    call, and no PyTorch operator but an allocation (which launches nothing)
    is dispatched, so no PyTorch kernel runs beside it; bit for bit with the
    plain twin. The operators are seen by a dispatch mode, not a profiler,
    so the device tracer is left alone."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from point_dae_torch.utils import kernels

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.add(str(func))
            return func(*args, **(kwargs or {}))

    x, mask, u, _, _ = _key_gather_case(dev, 64, 2048, 1024, 3, 35)
    want = gather.gather_by_mask_plain(x, mask, u)
    before = kernels.launches["key_gather"]
    with Ops() as seen:
        for _ in range(5):
            got = geometry.resample_batch(x, mask, 1024, draws=u)
    assert kernels.launches["key_gather"] == before + 5
    assert seen.ops <= {"aten.empty.memory_format"}, seen.ops
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,Q,N,C", [(16, 6144, 128, 1152), (16, 40960, 2048, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_kernel_matches_plain(dev, B, Q, N, C, dtype):
    """The part-segmentation shapes (PointTransformerPartSeg's interpolation,
    DGCNNPartSeg's edge gather): bit for bit with the plain version on the
    CPU (each element summed in ascending q; a bf16 g widened to f32 first),
    the same bits on a second launch, rows no q names at zero; the backward
    of ``gather_rows`` inside the gate launches the kernel and casts to g's
    type."""
    from point_dae_torch.utils import kernels

    g_ = _gen(dev, 9)
    idx = torch.randint(0, N - N // 8, (B, Q), generator=g_, device=dev, dtype=torch.int32)
    idx[:, ::7] = 3                                     # a hub row
    g = torch.randn((B, Q, C), generator=g_, device=dev).to(dtype)
    got = gather.scatter_rows_add(idx, g, N)
    again = gather.scatter_rows_add(idx, g, N)
    want = gather.scatter_rows_add_plain(idx.cpu(), g.cpu(), N)
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert torch.equal(got.cpu(), want)
    assert not got[:, N - N // 8:].any()
    x = torch.zeros((B, N, C), device=dev, dtype=dtype, requires_grad=True)
    before = kernels.launches["scatter_rows_add"]
    gather.gather_rows(x, idx).backward(g)
    assert kernels.launches["scatter_rows_add"] == before + 1
    assert x.grad.dtype == dtype and torch.equal(x.grad, got.to(dtype))


@pytest.fixture(scope="module")
def parents():
    """The previous aggregate and scatter designs (point_dae_torch/tools/
    aggregate_parent.cu, scatter_parent.cu), built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from point_dae_torch.tools import rowreduce_ablation

    return {n: lib for n, (lib, _) in
            rowreduce_ablation.build(["aggregate_parent", "scatter_parent"]).items()}


AGG_LIMIT = edgeconv.BLOCK_SMEM // 16      # the last N a 4-channel slice takes


@pytest.mark.parametrize("N", [1, 20, 1023, 1024, 2048, 4096, AGG_LIMIT + 1])
@pytest.mark.parametrize("C", [3, 64, 66, 256])
def test_aggregate_is_exact_against_plain_and_previous_design(dev, parents, N, C):
    """aggregate_from_idx under its plan (the staged form, or the L2 form one
    point past the staged form's limit) at k 1, 20 and 64 (repeated rows
    where k > N), track on and off: every output bit for bit with the plain
    version and the previous design, the same bits on a second launch."""
    from point_dae_torch.tools import rowreduce_ablation

    B = 128 if N <= 20 else 4 if N <= 4096 else 1
    g = _gen(dev, N + C)
    U = torch.randn((B, N, C), generator=g, device=dev).bfloat16().float()
    U[:, N // 2:N // 2 + min(N // 2, 8)] = U[:, :min(N // 2, 8)]      # value ties
    plan = edgeconv.aggregate_plan(B, N, C)
    assert plan.form == ("L2" if N > AGG_LIMIT else "staged")
    for k in (1, 20, 64):
        idx = torch.randint(0, N, (B, N, k), generator=g, device=dev, dtype=torch.int32)
        want = edgeconv.aggregate_plain(U, idx)
        for track in (True, False):
            got = edgeconv.aggregate_fwd_kernel(U, idx, track)
            again = edgeconv.aggregate_fwd_kernel(U, idx, track)
            prev = rowreduce_ablation.parent_aggregate(parents["aggregate_parent"], U, idx, track)
            outs = 6 if track else 4
            assert all(t is None for t in got[outs:])
            for i in range(outs):
                assert torch.equal(got[i], again[i]) and torch.equal(got[i], prev[i]), (k, i)
                assert torch.equal(got[i].to(want[i].dtype), want[i]), (k, track, i)


@pytest.mark.parametrize("plan", [edgeconv.AggPlan(lanes, chunks) for lanes in (0, 1, 2, 4, 8)
                                  for chunks in (1, 3)])
def test_aggregate_gives_the_same_bits_under_every_plan(dev, plan):
    """Every slice width (and the L2 form), whole clouds and three row
    chunks, at C 66 (a ragged last slice, rows not 16-byte aligned) and C 64."""
    g = _gen(dev, 31)
    for C in (66, 64):
        U = torch.randn((3, 300, C), generator=g, device=dev)
        idx = torch.randint(0, 300, (3, 300, 20), generator=g, device=dev, dtype=torch.int32)
        got = edgeconv.aggregate_fwd_kernel(U, idx, True, use_plan=plan)
        for a, b in zip(got, edgeconv.aggregate_plain(U, idx)):
            assert torch.equal(a.to(b.dtype), b), (plan, C)


# (B, Q, N): Q that no segment count divides, one row, 2048 rows
SCATTER_EDGES = [(3, 40961, 2048), (2, 5000, 1), (4, 6143, 128), (1, 777, 2048)]


def _scatter_idx(dev, B, Q, N, kind, seed):
    g = _gen(dev, seed)
    idx = torch.randint(0, N, (B, Q), generator=g, device=dev, dtype=torch.int32)
    if kind == "hub":
        idx[:, ::3] = N // 2                          # a third of the entries to one row
    elif kind == "one row":
        idx[:] = N - 1                                # every row unnamed but one
    elif kind == "outside":
        idx[:, 1::7] = -1 - idx[:, 1::7]              # outside [0, N): add nothing
        idx[:, 2::9] = N + idx[:, 2::9]
    return idx


@pytest.mark.parametrize("B,Q,N", SCATTER_EDGES)
@pytest.mark.parametrize("kind", ["hub", "one row", "outside"])
def test_scatter_kernel_is_exact_at_edge_cases(dev, parents, B, Q, N, kind):
    """f32 and bf16 g, every load width the kernel takes (f32 V 1, 2, 4; bf16
    V 1, 2, 4, 8) with the lanes that cover C 64, under the plan's segments:
    bit for bit with the plain version on the CPU and with the previous
    design, the same bits on a second launch."""
    from point_dae_torch.tools import rowreduce_ablation

    idx = _scatter_idx(dev, B, Q, N, kind, Q + N)
    C = 64
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn((B, Q, C), generator=_gen(dev, Q), device=dev).to(dtype)
        want = gather.scatter_rows_add_plain(idx.cpu(), g.cpu(), N)
        prev = rowreduce_ablation.parent_scatter(parents["scatter_parent"], idx, g, N)
        assert torch.equal(prev.cpu(), want)
        base = gather.scatter_plan(B, Q, C, g.element_size(), 256)
        for vec in ((1, 2, 4, 8) if dtype == torch.bfloat16 else (1, 2, 4)):
            lanes = min(32, C // vec)
            plan = base._replace(vec=vec, lanes=lanes)
            got = gather.scatter_rows_add(idx, g, N, use_plan=plan)
            again = gather.scatter_rows_add(idx, g, N, use_plan=plan)
            assert torch.equal(got, again) and torch.equal(got, prev), (dtype, vec)
            assert torch.equal(got.cpu(), want), (dtype, vec)


@pytest.mark.parametrize("B,Q,N", SCATTER_EDGES + [(16, 40960, 2048), (16, 6144, 128)])
@pytest.mark.parametrize("segs", [1, 7, 16])
def test_scatter_sort_scratch_matches_its_plain_layout(dev, B, Q, N, segs):
    """The counting sort alone (the library's ``scatter_lists`` entry):
    segment counts, list starts and lists as ``scatter_lists_plain`` lays
    them out, idx outside [0, N) left out."""
    idx = _scatter_idx(dev, B, Q, N, "outside", 3 * Q + segs)
    counts, start, order = gather.scatter_lists_kernel(idx, N, segs)
    w_counts, w_start, w_order = gather.scatter_lists_plain(idx.cpu(), N, segs)
    torch.cuda.synchronize()
    assert torch.equal(counts.cpu(), w_counts) and torch.equal(start.cpu(), w_start)
    for b in range(B):
        n = int(w_start[b, N])
        assert torch.equal(order[b, :n].cpu(), w_order[b, :n])


def _fps_cloud(dev, B, N, seed=8):
    """Normal points, a block of them duplicated, a few at the origin and one
    just inside the unselectable radius."""
    pts = torch.randn((B, N, 3), generator=_gen(dev, seed), device=dev)
    pts[:, N // 2:N // 2 + N // 8] = pts[:, :N // 8]
    pts[0, 3:9] = 0.0
    pts[-1, min(11, N - 1)] = 0.018
    return pts


@pytest.mark.parametrize("B,N,n", [(3, 1024, 200), (2, 512, 512), (2, 1200, 1024),
                                   (1, 8192, 300), (2, 700, 64), (2, 2048, 2048),
                                   (2, 8200, 300), (2, 16384, 256), (1, 20480, 200),
                                   (2, 65536, 64), (1, 65544, 48), (1, 100000, 32),
                                   (33, 2048, 100), (40, 8192, 64)])
def test_fps_kernel_matches_plain(dev, B, N, n):
    """Bit for bit under the plan of each shape: n < N, n == N (the picks
    repeat once the selectable points run out), N not a multiple of 1024 and
    of 128, duplicated points and points inside the unselectable radius;
    one block, clusters of 2, 4 and 8 (65536 points, the most the registers
    hold), and above 65536 points the streamed form."""
    pts = _fps_cloud(dev, B, N)
    got = fps_ops.fps_kernel(pts, n)
    want = fps_ops.furthest_point_sample_plain(pts, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not any(i in got[0, 1:].tolist() for i in range(3, 9))


# every points-a-thread and cluster size of the kernel, with shares that do
# not divide N and blocks past the cloud's end
FPS_PLANS = [(c, t, p) for c in fps_ops.CLUSTERS for p in fps_ops.PPTS for t in (32, 96, 256)]


@pytest.mark.parametrize("cluster,threads,ppt", FPS_PLANS)
def test_fps_kernel_matches_plain_under_every_plan(dev, cluster, threads, ppt):
    """Each (cluster, threads, points a thread) the kernel instantiates, at
    the largest cloud it holds less 37 points and at a cloud smaller than its
    threads: the picks bit for bit the plain version's."""
    for N in (cluster * threads * ppt - 37, cluster * threads // 3):
        pts = _fps_cloud(dev, 2, N, seed=N)
        n = min(N, 96)
        got = fps_ops.fps_kernel(pts, n, use_plan=fps_ops.FpsPlan(cluster, threads, ppt))
        want = fps_ops.furthest_point_sample_plain(pts, n)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (N, n)


def test_fps_runs_the_plans_cluster_launch(dev):
    """At the fine-tune shapes the plan takes a cluster and the profiler sees
    the kernel of that plan (its template arguments), never the one-block
    form; a plan the kernel does not take raises, so does a cluster size it
    has no instantiation of."""
    from torch.profiler import ProfilerActivity, profile

    for B, N, n in ((32, 8192, 1200), (32, 16384, 1024)):
        p = fps_ops.plan(B, N, *fps_ops.card(dev))
        assert p.form == "cluster" and p.cluster > 1
        pts = _fps_cloud(dev, B, N)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fps_ops.fps_kernel(pts, n)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if "fps_kernel" in e.key]
        assert names and all(f"fps_kernel<{p.ppt}, {p.cluster}>" in k for k in names), names
    pts = _fps_cloud(dev, 2, 4096)
    for bad in ((3, 256, 8), (2, 64, 8), (1, 512, 8), (2, 256, 12)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            fps_ops.fps_kernel(pts, 16, use_plan=fps_ops.FpsPlan(*bad))


def test_fps_dispatch_follows_the_gate(dev):
    """Inside the gate the kernel runs, above 8192 points too; outside it
    the plain version."""
    from point_dae_torch.utils import kernels

    pts = torch.randn((2, 1000, 3), generator=_gen(dev, 9), device=dev)
    before = kernels.launches["fps"]
    geometry.furthest_point_sample(pts, 16)
    assert kernels.launches["fps"] == before + 1
    geometry.furthest_point_sample(pts[:, :500], 16)           # below 512
    geometry.furthest_point_sample(pts[:, :999], 16)           # N % 8 != 0
    assert kernels.launches["fps"] == before + 1
    big = torch.randn((1, 8200, 3), generator=_gen(dev, 10), device=dev)
    assert torch.equal(geometry.furthest_point_sample(big, 16),
                       fps_ops.furthest_point_sample_plain(big, 16))
    assert kernels.launches["fps"] == before + 2


@pytest.mark.parametrize("name", ["PointTransformer", "DGCNN"])
def test_tiny_finetune_step_on_the_card(dev, name):
    """One train step, an eval step and a 2-draw vote step of a small
    fine-tune model on the card: finite loss, the FPS kernel launched."""
    from point_dae_torch.engine import finetune
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.models import build_model_from_cfg
    from point_dae_torch.utils import kernels

    model_cfg = {"NAME": name, "cls_dim": 15}
    if name == "PointTransformer":
        model_cfg.update(trans_dim=64, depth=2, drop_path_rate=0.1, num_heads=2,
                         group_size=16, num_group=32, encoder_dims=64)
    cfg = {"optimizer": {"type": "AdamW", "part": "all",
                         "kwargs": {"lr": 5e-4, "weight_decay": 0.05}},
           "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300}},
           "model": model_cfg, "npoints": 1024, "grad_norm_clip": 10}
    model = build_model_from_cfg(model_cfg, device=dev)
    state = TrainState.create(model, cfg, 10, grad_norm_clip=10)
    g = _gen(dev, 10)
    pts = torch.randn((4, 2048, 3), generator=g, device=dev)
    labels = torch.randint(0, 15, (4,), generator=g, device=dev)
    kernels.reset_launches()
    m = finetune.make_finetune_step(model, cfg, smooth=True)(state, pts, labels, generator=g)
    assert math.isfinite(float(m["loss"])) and kernels.launches["fps"] == 1
    logits = finetune.make_eval_step(model, cfg)(pts)
    vote = finetune.make_vote_step(model, cfg, times=2)(pts, generator=g)
    assert logits.shape == vote.shape == (4, 15)
    assert torch.isfinite(logits).all() and torch.isfinite(vote).all()
    assert kernels.launches["fps"] == 4


@pytest.fixture(scope="module")
def chamfer_parent():
    """The previous chamfer design (point_dae_torch/tools/chamfer_parent.cu),
    built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from point_dae_torch.tools import chamfer_ablation

    return chamfer_ablation.build(["chamfer_parent"])["chamfer_parent"][0]


def _assert_pair_exact(got, x, y, parent, small):
    """A pair entry's outputs bit for bit with the two plain halves and with
    the previous design's two launches."""
    from point_dae_torch.tools import chamfer_ablation

    plain = chamfer.nn_half_small_plain if small else chamfer.nn_half_tiled_plain
    want = plain(x, y) + plain(y, x)
    prev = chamfer_ablation.parent_pair(parent, x, y, small)
    assert len(got) == len(want) == len(prev)
    for i, (a, b, c) in enumerate(zip(got, want, prev)):
        assert torch.equal(a, b), i
        assert torch.equal(a, c), i


@pytest.mark.parametrize("B,N,M", [(3, 700, 1500), (2, 512, 512), (1, 1, 262144),
                                   (1, 262144, 1), (4, 1023, 2049), (128, 1024, 1024)])
def test_tiled_chamfer_pair_is_exact(dev, chamfer_parent, B, N, M):
    """Both directions in one launch under the plan, bit for bit with the
    plain halves and the previous design: a duplicated target in two column
    ranges of the plan and in two chunks of one range (an exact hit on it, so
    the first copy must win), exact hits; the same bits on a second launch
    and under plans with other groups and rows a thread."""
    g = _gen(dev, N + M)
    x = torch.randn((B, N, 3), generator=g, device=dev)
    y = torch.randn((B, M, 3), generator=g, device=dev)
    plan = chamfer.tiled_plan(B, N, M)
    for t, cols, other in ((y, M, x), (x, N, y)):
        ranges = [r for r in plan.ranges(cols) if r[1] > r[0]]
        src = min(10, cols - 1)
        dups = [c for c in (src + 3 * chamfer.TILED_CHUNK, ranges[-1][0] + 1) if src < c < cols]
        for c in dups:
            t[:, c] = t[:, src]
        other[:, 0] = t[:, src]                        # an exact hit on the duplicated target
    x[:, -1] = y[:, M // 2]
    got = chamfer.nn_half_tiled_pair(x, y)
    _assert_pair_exact(got, x, y, chamfer_parent, small=False)
    assert all(torch.equal(a, b) for a, b in zip(got, chamfer.nn_half_tiled_pair(x, y)))
    for p in (plan._replace(groups=1, piece=chamfer.TILED_STAGE),
              chamfer.TiledPlan(8, 8, 4, 300), chamfer.TiledPlan(1, 2, 2, 64)):
        assert all(torch.equal(a, b) for a, b in zip(got, chamfer.nn_half_tiled_pair(x, y, p))), p
    assert float(got[0].min()) >= 0.0 and float(got[2].min()) >= 0.0


@pytest.mark.parametrize("case", ["equal_targets", "large", "subnormal"])
def test_tiled_chamfer_pair_is_exact_at_edge_values(dev, chamfer_parent, case):
    """Every target equal (index 0 everywhere), coordinates near 1e3, and
    near 1e-20 (products under f32's least normal): bit for bit with the
    plain halves and the previous design."""
    g = _gen(dev, 61)
    B, N, M = 2, 600, 900
    x = torch.randn((B, N, 3), generator=g, device=dev)
    y = torch.randn((B, M, 3), generator=g, device=dev)
    if case == "equal_targets":
        y[:] = y[:, :1]
        x[:] = x[:, :1]
    elif case == "large":
        x, y = 1e3 + x, 1e3 + y
    else:
        x, y = 1e-20 * x, 1e-20 * y
    got = chamfer.nn_half_tiled_pair(x, y)
    _assert_pair_exact(got, x, y, chamfer_parent, small=False)
    if case == "equal_targets":
        assert int(got[1].max()) == 0 and int(got[3].max()) == 0


@pytest.mark.parametrize("P", [100, 4096, 4097, 13056])
@pytest.mark.parametrize("N,M", [(36, 32), (32, 36), (1, 64), (64, 1), (64, 64), (17, 5)])
def test_patch_chamfer_pair_is_exact(dev, chamfer_parent, P, N, M):
    """Both directions in one launch under the plan, bit for bit with the
    plain halves and the previous design (dist, idx and near): tied targets,
    identical patches, exact hits; the same bits on a second launch and
    under other plans."""
    g = _gen(dev, P + N + M)
    x = 0.1 * torch.randn((P, N, 3), generator=g, device=dev)
    y = 0.1 * torch.randn((P, M, 3), generator=g, device=dev)
    if M > 9:
        y[:, 9] = y[:, 3]                              # tie: first index wins
    if N > 7:
        x[:, 7] = x[:, 2]
    x[1], y[1] = x[0], y[0]                            # identical patches
    x[2, 0] = y[2, -1]                                 # an exact hit
    got = chamfer.nn_half_small_pair(x, y)
    _assert_pair_exact(got, x, y, chamfer_parent, small=True)
    assert all(torch.equal(a, b) for a, b in zip(got, chamfer.nn_half_small_pair(x, y)))
    for p in (chamfer.PatchPlan(1, 32), chamfer.PatchPlan(5, 96), chamfer.PatchPlan(32, 256)):
        assert all(torch.equal(a, b) for a, b in zip(got, chamfer.nn_half_small_pair(x, y, p))), p
    assert all(torch.equal(a, b) for a, b in zip(got[:3], chamfer.nn_half_small(x, y)))


@pytest.mark.parametrize("shapes", [((4096, 36, 3), (4096, 32, 3)),
                                    ((2, 700, 3), (2, 1500, 3))])
def test_nn_distance_launches_one_chamfer_kernel_a_call(dev, shapes):
    """nn_distance takes its gate's pair entry: one launch a call, both
    directions equal to the plain halves, gradients finite."""
    from point_dae_torch.utils import kernels

    g = _gen(dev, 62)
    x = torch.randn(shapes[0], generator=g, device=dev).requires_grad_()
    y = torch.randn(shapes[1], generator=g, device=dev).requires_grad_()
    small = chamfer.use_small_kernel(x, y.shape[1])
    name = "nn_half_small" if small else "nn_half_tiled"
    assert small or chamfer.use_tiled_kernel(x, y.shape[1])
    kernels.reset_launches()
    d1, d2, i1, i2 = chamfer.nn_distance(x, y)
    assert kernels.launches[name] == 1 and sum(kernels.launches.values()) == 1
    plain = chamfer.nn_half_small_plain if small else chamfer.nn_half_tiled_plain
    w1, w2 = plain(x.detach(), y.detach()), plain(y.detach(), x.detach())
    assert torch.equal(i1, w1[1]) and torch.equal(i2, w2[1])
    assert torch.equal(d1, w1[0].clamp_min(0.0)) and torch.equal(d2, w2[0].clamp_min(0.0))
    (d1.mean() + d2.mean()).backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(y.grad).all()
