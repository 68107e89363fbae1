#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (point_dae_torch) on one NVIDIA GPU.

Phases, each fatal on failure:
  1. card   - name and power limit from nvidia-smi;
  2. build  - compile every kernel of the flagship pretrain step from
              point_dae_torch/csrc with nvcc (sm_90a), all at once;
  3. kernels- at the step's shapes, hold each kernel against its plain
              PyTorch version on the card and time kernel, plain version
              and (where one exists) a single PyTorch library call;
  4. check  - one forward of the full-width model at batch 128 (every
              kernel gate open) on the card against the same forward on
              the CPU, which takes the plain paths (the paths the CPU
              parity tests hold against the JAX package);
  5. train  - 5 flagship pretrain steps of the default configuration
              (batch 256 from a raw (256, 8192, 6) tensor, trans_dim 384,
              depth 12 + 4, bf16, fold_impl auto: all six kernels) with
              every launch counter zeroed before and read after, one
              profiled step, then as many steps of a second model with
              fold_impl xla (the plain folding head) beside it.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Run from the repository root:

    python3 chip_smoke.py
"""
import copy
import json
import math
import os
import subprocess
import sys
import time

SEED = 0
BATCH, NRAW = 256, 8192
CHECK_BATCH = 128          # smallest batch at which every kernel gate opens
TRAIN_STEPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor cores
F32_FLOPS = 67e12          # f32 outside the tensor cores

XLA_STEPS = 5              # steps of the fold_impl xla model run beside the default
FLAGSHIP_CONFIG = {        # __graft_entry__.FLAGSHIP_CONFIG at bs 256
    "optimizer": {"type": "AdamW", "part": "all",
                  "kwargs": {"lr": 0.001, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300, "initial_epochs": 10}},
    "dataset": {"train": {"others": {
        "subset": "train", "npoints": 1024, "aug_type": ["norm"],
        "corrupt_type": ["clean"], "whole": True}}},
    "model": {
        "NAME": "PointCAE_transformer_fc_global_folding_local",
        "corrupt_type": ["affine_r3", "Drop-Patch"],
        "all_patch": "False", "group_size": 32, "num_group": 64, "loss": "cdl2",
        "transformer_config": {
            "rand_ratio": "True", "mask_ratio": 0.6, "mask_type": "rand",
            "trans_dim": 384, "encoder_dims": 384, "depth": 12,
            "drop_path_rate": 0.1, "cls_dim": 55, "num_heads": 6,
            "decoder_depth": 4, "decoder_num_heads": 6,
            "dtype": "bf16"}},
    "normal_weight": 0.005, "npoints": 1024, "total_bs": BATCH,
    "step_per_update": 1, "max_epoch": 300, "loss_type": "xyznormal",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn, CUDA events, after two warm-ups."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-12)


def relu_flips_ok(got, want, tol=2e-2, flip_tol=1e-1, flip_frac=1e-4) -> bool:
    """The folding head's bound: error over the plain version's largest
    magnitude within ``tol`` (bf16 operands: 2^-8 a rounding, summed), except
    that at most ``flip_frac`` of a tensor's elements may reach ``flip_tol``:
    where an f32 sum lands on the other side of zero in its last bit, a ReLU
    mask switches one cotangent element on or off, which moves that token's
    dx by about a hundredth of the largest dx (36 x 384 terms a token)."""
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs() / (float(want.abs().max()) + 1e-12)
    return float(err.max()) <= flip_tol and float((err > tol).float().mean()) <= flip_frac


def phase_kernels(torch, pts, device):
    """Each kernel against its plain version at the flagship shapes."""
    from point_dae_torch.losses import chamfer
    from point_dae_torch.ops import gather, mlp, patchify
    from point_dae_torch.ops.geometry import group_neighborhood

    records = {}
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    B, N, _ = pts.shape
    G, S = 64, 32

    # -- patchify: fps exact; knn only at genuine near-ties (tools/tpu_smoke.py)
    fps_k, knn_k = patchify.fused_patchify(pts, G, S)
    fps_p, knn_p = patchify.fused_patchify_plain(pts, G, S)
    torch.cuda.synchronize()
    if not torch.equal(fps_k, fps_p):
        fail("patchify: fps_idx differs from the plain version")
    center = pts.gather(1, fps_k.long()[..., None].expand(-1, -1, 3))
    d_all = ((pts[:, None] - center[:, :, None]) ** 2).sum(-1)     # (B, G, N)
    dk = d_all.gather(-1, knn_k.long())
    dp = d_all.gather(-1, knn_p.long())
    match = float((knn_k == knn_p).float().mean())
    if not (torch.allclose(dk, dp, rtol=1e-4, atol=1e-4) and match > 0.9999):
        fail(f"patchify: knn disagrees beyond near-ties (idx match {match})")
    nbytes = pts.numel() * 4 + fps_k.numel() * 4 + knn_k.numel() * 4
    records["patchify"] = dict(
        replaces="point_dae_tpu/ops/pallas_patchify.py:43",
        source="point_dae_torch/csrc/patchify.cu",
        max_abs_err=float((dk - dp).abs().max()),       # selected kNN distances
        ms=cuda_ms(lambda: patchify.fused_patchify(pts, G, S), 20),
        plain_ms=cuda_ms(lambda: patchify.fused_patchify_plain(pts, G, S), 3),
        library_ms=None, bound=bound_ms(nbytes, B * G * N * 8, F32_FLOPS),
        note=f"knn idx match {match:.6f}")

    # -- small-C gather: exact
    idx = knn_k.reshape(B, G * S)
    got = gather.gather_rows_small_c(pts, idx)
    want = gather.gather_rows_small_c_plain(pts, idx)
    if not torch.equal(got, want):
        fail("gather: kernel differs from the plain version")
    idx64 = idx.long()[..., None].expand(-1, -1, 3)
    nbytes = pts.numel() * 4 + idx.numel() * 4 + got.numel() * 4
    records["gather_rows_small_c"] = dict(
        replaces="point_dae_tpu/ops/pallas_scatter.py:116",
        source="point_dae_torch/csrc/gather.cu",
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(lambda: gather.gather_rows_small_c(pts, idx), 50),
        plain_ms=cuda_ms(lambda: gather.gather_rows_small_c_plain(pts, idx), 50),
        library_ms=cuda_ms(lambda: torch.gather(pts, 1, idx64), 50),
        bound=bound_ms(nbytes, 0, F32_FLOPS))

    # -- patch chamfer: 256*51 patches, 36 rebuilt points vs 32 true ones
    neigh, _ = group_neighborhood(pts, G, S)
    y = neigh[:, :51].reshape(-1, S, 3).contiguous()               # (13056, 32, 3)
    x = (torch.randn((y.shape[0], 36, 3), generator=g, device=device) * 0.05).contiguous()
    errs = []
    for a, b in ((x, y), (y, x)):
        dk_, ik, nk = chamfer.nn_half_small(a, b)
        dp_, ip, np_ = chamfer.nn_half_small_plain(a, b)
        same = float((ik == ip).float().mean())
        if not (torch.allclose(dk_, dp_, rtol=1e-6, atol=0) and same > 0.9999):
            fail(f"patch chamfer: dist/idx disagree (idx match {same})")
        errs.append(float((dk_ - dp_).abs().max()))

    def lib_chamfer():
        d = torch.cdist(x, y) ** 2
        return d.min(2).values, d.min(1).values

    P, Nq, M = x.shape[0], 36, 32
    nbytes = 2 * (P * (Nq * 3 + M * 3) * 4) + P * (Nq + M) * (4 + 4 + 12)
    records["nn_half_small"] = dict(
        replaces="point_dae_tpu/losses/chamfer.py:107",
        source="point_dae_torch/csrc/chamfer.cu", max_abs_err=max(errs),
        ms=cuda_ms(lambda: (chamfer.nn_half_small(x, y), chamfer.nn_half_small(y, x)), 20),
        plain_ms=cuda_ms(lambda: (chamfer.nn_half_small_plain(x, y),
                                  chamfer.nn_half_small_plain(y, x)), 5),
        library_ms=cuda_ms(lib_chamfer, 20),
        bound=bound_ms(nbytes, 2 * P * Nq * M * 8, F32_FLOPS),
        note="both directions, 36 vs 32 and 32 vs 36")

    # -- fused LN + MLP + residual: decoder shape R = 256 * 64
    R, C, H = BATCH * 64, 384, 1536
    xm = torch.randn((R, C), generator=g, device=device)
    gm = 1 + 0.1 * torch.randn((C,), generator=g, device=device)
    bt = 0.05 * torch.randn((C,), generator=g, device=device)
    k1 = torch.randn((C, H), generator=g, device=device) / math.sqrt(C)
    b1 = 0.02 * torch.randn((H,), generator=g, device=device)
    k2 = torch.randn((H, C), generator=g, device=device) / math.sqrt(H)
    b2 = 0.02 * torch.randn((C,), generator=g, device=device)
    keep = torch.rand((BATCH,), generator=g, device=device) >= 0.1
    sc = torch.where(keep, 1 / 0.9, 0.0).repeat_interleave(64).contiguous()
    cot = torch.randn((R, C), generator=g, device=device)
    bf = torch.bfloat16
    k1b, k2b = k1.to(bf).contiguous(), k2.to(bf).contiguous()
    leaves = [t.clone().requires_grad_() for t in (xm, gm, bt, k1, b1, k2, b2)]
    y_k = mlp.fused_mlp_ln(*leaves, row_scale=sc)
    gk = torch.autograd.grad(y_k, leaves, cot)
    plain = [t.clone().requires_grad_() for t in (xm, gm, bt, k1, b1, k2, b2)]
    y_p = mlp.fused_mlp_ln_plain(*plain, row_scale=sc)
    gp = torch.autograd.grad(y_p, plain, cot)
    worst = {"y": rel_err(y_k - xm, y_p - xm)}
    abs_err = {"y": float((y_k - y_p).detach().abs().max())}
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dk1", "db1", "dk2", "db2"), gk, gp):
        worst[name] = rel_err(a, b)
        abs_err[name] = float((a.float() - b.float()).abs().max())
    log("  fused_mlp_ln max error / max |plain|: "
        + " ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    if max(worst.values()) > 2e-2:      # bf16 operands: 2^-8 per rounding, summed
        fail(f"fused_mlp_ln disagrees with its plain version: {worst}")
    fwd_args = (xm, gm, bt, k1b, b1, k2b, b2, sc)
    fwd_ms = cuda_ms(lambda: mlp.mlp_ln_fwd_kernel(*fwd_args), 20)
    bwd_ms = cuda_ms(lambda: mlp.mlp_ln_bwd_kernel(xm, gm, bt, k1b, b1, k2b, sc, cot), 10)
    yp2 = mlp.fused_mlp_ln_plain(*plain, row_scale=sc)
    plain_fwd = cuda_ms(lambda: mlp.fused_mlp_ln_plain(xm, gm, bt, k1, b1, k2, b2, sc), 10)
    plain_bwd = cuda_ms(lambda: torch.autograd.grad(yp2, plain, cot, retain_graph=True), 10)
    io = R * C * 4
    wbytes = 2 * C * H * 2
    mm = 2 * R * C * H
    for name, ms, pms, nbytes, flops, err in (
            ("mlp_ln_fwd", fwd_ms, plain_fwd, 2 * io + wbytes + R * 4, 2 * mm, abs_err["y"]),
            ("mlp_ln_bwd", bwd_ms, plain_bwd, 3 * io + 2 * wbytes + R * 4 + C * H * 4,
             5 * mm, max(v for k, v in abs_err.items() if k != "y"))):
        records[name] = dict(
            replaces="point_dae_tpu/ops/pallas_mlp.py:"
                     + ("227" if name.endswith("fwd") else "244"),
            source="point_dae_torch/csrc/mlp.cu", max_abs_err=err, ms=ms,
            plain_ms=pms, library_ms=None, bound=bound_ms(nbytes, flops, BF16_FLOPS),
            note=f"R {R}, C {C}, H {H}")
    # the encoder's shape, R = 256 * 32, printed for PERF.md
    xe = xm[: BATCH * 32].contiguous()
    sce = sc[: BATCH * 32].contiguous()
    log(f"  fused_mlp_ln at R {xe.shape[0]}: fwd "
        f"{cuda_ms(lambda: mlp.mlp_ln_fwd_kernel(xe, gm, bt, k1b, b1, k2b, b2, sce), 20):.4f} ms, bwd "
        f"{cuda_ms(lambda: mlp.mlp_ln_bwd_kernel(xe, gm, bt, k1b, b1, k2b, sce, cot[: xe.shape[0]].contiguous()), 10):.4f} ms")

    records.update(phase_folding(torch, device, g))
    records.update(phase_attention(torch, device, g))
    return records


def phase_folding(torch, device, g):
    """The fused folding head at the step's shape (256 * 51 tokens, C = F =
    384, 36 grid points) against its plain version on the card: the output
    and all thirteen gradients."""
    from point_dae_torch.models.common import folding_grid
    from point_dae_torch.ops import folding

    Bt, M, C, n = BATCH, 51, 384, 36
    T, R = Bt * M, Bt * M * n
    grid = torch.from_numpy(folding_grid((6, 6))).to(device)

    def stage(extra):
        def w(i, o):
            return torch.randn((i, o), generator=g, device=device) / math.sqrt(i)
        return [w(C + extra, C), 0.02 * torch.randn((C,), generator=g, device=device),
                w(C, C), 0.02 * torch.randn((C,), generator=g, device=device),
                w(C, 3), 0.02 * torch.randn((3,), generator=g, device=device)]

    flat = [torch.randn((Bt, M, C), generator=g, device=device)] + stage(2) + stage(3)
    cot = torch.randn((Bt, M, n, 3), generator=g, device=device)
    names = ["dx"] + [f"d{k}{i}{s}" for s in (1, 2) for i in range(3) for k in "kb"]

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in flat]
        p1 = tuple((leaves[1 + 2 * i], leaves[2 + 2 * i]) for i in range(3))
        p2 = tuple((leaves[7 + 2 * i], leaves[8 + 2 * i]) for i in range(3))
        out = fn(leaves[0], grid, p1, p2)
        return (out, torch.autograd.grad(out, leaves, cot, retain_graph=True),
                (leaves[0], p1, p2))

    out_k, gk, _ = run(folding.fused_folding)
    out_p, gp, (xl, p1, p2) = run(folding.fused_folding_plain)
    torch.cuda.synchronize()
    worst = {"out": rel_err(out_k, out_p)}
    abs_err = {"out": float((out_k - out_p).detach().abs().max())}
    ok = relu_flips_ok(out_k, out_p)
    for name, a, b in zip(names, gk, gp):
        worst[name] = rel_err(a, b)
        abs_err[name] = float((a.float() - b.float()).abs().max())
        ok = ok and relu_flips_ok(a, b)
    log("  fused_folding max error / max |plain|: "
        + " ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    if not ok:
        fail(f"fused_folding disagrees with its plain version: {worst}")
    del gk, gp, out_k

    with torch.no_grad():
        core = folding.core_operands(xl, grid, p1, p2)
        ops = folding.kernel_operands(*core)
        gpad = cot.reshape(R, 3).contiguous()
        fwd_ms = cuda_ms(lambda: folding.folding_fwd_kernel(*ops), 10)
        bwd_ms = cuda_ms(lambda: folding.folding_bwd_kernel(*ops, gpad), 5)
        plain_fwd = cuda_ms(lambda: folding._FoldCorePlain.apply(*core), 3)
    leaves = [xl] + [t for st in (p1, p2) for pair in st for t in pair]
    plain_bwd = cuda_ms(lambda: torch.autograd.grad(out_p, leaves, cot, retain_graph=True), 3)
    F = C
    wide = 2 * 2 * R * F * F                     # a0 @ k11 and a2 @ k12
    shared = 2 * T * C * 2 * F                   # x @ [ks1 | ks2]
    narrow = 3 * 2 * R * F * 3                   # @ k21, @ ke2, @ k22
    flops = wide + shared + narrow
    wbytes = (2 * C * F + 2 * F * F + n * F + 13 * F) * 2
    records = {}
    for name, ms, pms, nbytes, fl, err in (
            ("folding_fwd", fwd_ms, plain_fwd, T * C * 2 + wbytes + R * 3 * 4, flops,
             abs_err["out"]),
            ("folding_bwd", bwd_ms, plain_bwd,
             2 * T * C * 2 + 2 * wbytes + R * 3 * 4, 3 * flops,
             max(v for k, v in abs_err.items() if k != "out"))):
        records[name] = dict(
            replaces="point_dae_tpu/ops/pallas_folding.py:"
                     + ("188" if name.endswith("fwd") else "225"),
            source="point_dae_torch/csrc/folding.cu", max_abs_err=err, ms=ms,
            plain_ms=pms, library_ms=None, bound=bound_ms(nbytes, fl, BF16_FLOPS),
            note=f"{T} tokens x {n} points, C = F = {C}")
    return records


def phase_attention(torch, device, g):
    """The fused attention at the step's two shapes (B 256, H 6, d 64; T 32
    with 13 to 32 valid keys a cloud, T 64 without a mask) against its plain
    version on the card: output, dq, dk, dv, and exact zeros on the
    gradients of invalid keys. library_ms is one call of
    F.scaled_dot_product_attention on the same bf16 inputs (timing only)."""
    import torch.nn.functional as F
    from point_dae_torch.ops import attention

    Bt, H, d = BATCH, 6, 64
    bf = torch.bfloat16
    errs, shapes = {"fwd": 0.0, "bwd": 0.0}, {}
    for T, masked in ((32, True), (64, False)):
        qkv = torch.randn((Bt, T, 3, H, d), generator=g, device=device)
        cot = torch.randn((Bt, T, H, d), generator=g, device=device)
        mask = None
        if masked:
            valid = torch.randint(13, T + 1, (Bt,), generator=g, device=device)
            mask = torch.arange(T, device=device)[None, :] < valid[:, None]

        def run(fn):
            leaf = qkv.clone().requires_grad_()
            q, k, v = leaf.to(bf).unbind(2)
            out = fn(q, k, v, mask)
            return (out, torch.autograd.grad(out, leaf, cot, retain_graph=True)[0],
                    leaf, (q, k, v))

        out_k, gk, _, _ = run(attention.fused_attention)
        out_p, gp, leaf_p, (q, k, v) = run(attention.fused_attention_plain)
        torch.cuda.synchronize()
        worst = {"out": rel_err(out_k, out_p)}
        for i, name in enumerate(("dq", "dk", "dv")):
            worst[name] = rel_err(gk[:, :, i], gp[:, :, i])
        log(f"  fused_attention T {T} max error / max |plain|: "
            + " ".join(f"{k_} {v_:.2e}" for k_, v_ in worst.items()))
        if max(worst.values()) > 2e-2:  # bf16 operands: 2^-8 per rounding, summed
            fail(f"fused_attention (T {T}) disagrees with its plain version: {worst}")
        if masked and float(gk[:, :, 1:][~mask].abs().max()) != 0.0:
            fail("fused_attention: an invalid key got a gradient")
        errs["fwd"] = max(errs["fwd"], float((out_k - out_p).detach().abs().max()))
        errs["bwd"] = max(errs["bwd"], float((gk - gp).abs().max()))

        q, k, v = (t.detach() for t in (q, k, v))
        lq, lk, lv = (t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v))
        amask = None if mask is None else mask[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=amask)
        lib_cot = cot.transpose(1, 2).to(bf)
        nel = Bt * T * H * d
        shapes[T] = dict(
            fwd=cuda_ms(lambda: attention.attention_fwd_kernel(q, k, v, mask), 50),
            bwd=cuda_ms(lambda: attention.attention_bwd_kernel(q, k, v, mask, cot), 50),
            plain_fwd=cuda_ms(lambda: attention.fused_attention_plain(q, k, v, mask), 10),
            plain_bwd=cuda_ms(lambda: torch.autograd.grad(
                out_p, leaf_p, cot, retain_graph=True), 10),
            lib_fwd=cuda_ms(lambda: F.scaled_dot_product_attention(
                lq.detach(), lk.detach(), lv.detach(), attn_mask=amask), 50),
            lib_bwd=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), lib_cot, retain_graph=True), 50),
            bound_fwd=bound_ms(3 * nel * 2 + Bt * T + nel * 4,
                               2 * 2 * Bt * H * T * T * d, BF16_FLOPS),
            bound_bwd=bound_ms(3 * nel * 2 + Bt * T + nel * 4 + 3 * nel * 2,
                               5 * 2 * Bt * H * T * T * d, BF16_FLOPS))
    s64 = shapes[64]
    log(f"  fused_attention at T 64: fwd {s64['fwd']:.4f} ms (plain {s64['plain_fwd']:.4f}, "
        f"library {s64['lib_fwd']:.4f}, bound {s64['bound_fwd'][0]:.4f}), bwd "
        f"{s64['bwd']:.4f} ms (plain {s64['plain_bwd']:.4f}, library {s64['lib_bwd']:.4f}, "
        f"bound {s64['bound_bwd'][0]:.4f})")
    s32 = shapes[32]
    records = {}
    for way, line in (("fwd", "144"), ("bwd", "168")):
        records[f"attention_{way}"] = dict(
            replaces=f"point_dae_tpu/ops/pallas_attn.py:{line}",
            source="point_dae_torch/csrc/attention.cu", max_abs_err=errs[way],
            ms=s32[way], plain_ms=s32[f"plain_{way}"], library_ms=s32[f"lib_{way}"],
            bound=s32[f"bound_{way}"],
            note="B 256, H 6, d 64, T 32 with a key mask (12 of a step's 16 launches)")
    return records


def phase_check(torch, config, raw, device):
    """Full-width forward at CHECK_BATCH on the card (kernels) and on the
    CPU (plain paths) with the same weights, points and draws."""
    from point_dae_torch.engine.pretrain import device_pipeline, init_model
    from point_dae_torch.utils import kernels

    cpu_model = init_model(config, seed=SEED + 2, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    d = config["dataset"]["train"]["others"]
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    _, clean = device_pipeline(raw[:CHECK_BATCH], d["aug_type"], d["corrupt_type"],
                               d["npoints"], generator=g, device=device)
    draws = gpu_model.sample_draws(CHECK_BATCH, g, device)
    before = dict(kernels.launches)
    with torch.no_grad():
        lg = [float(v) for v in gpu_model(clean, clean, draws=draws)]
        cpu_draws = copy.deepcopy(draws)
        for f in ("mask", "dp_encoder", "dp_decoder"):
            v = getattr(cpu_draws, f)
            setattr(cpu_draws, f, None if v is None else v.cpu())
        a = cpu_draws.affine
        a.A, a.b, a.m = a.A.cpu(), a.b.cpu(), a.m.cpu()
        clean_cpu = clean.cpu()
        t0 = time.perf_counter()
        lc = [float(v) for v in cpu_model(clean_cpu, clean_cpu, draws=cpu_draws)]
    used = {k: kernels.launches[k] - before[k] for k in before}
    log(f"  batch {CHECK_BATCH}: card (kernels) loss_xyz {lg[0]:.6f} loss_global {lg[1]:.6f}; "
        f"cpu (plain, {time.perf_counter() - t0:.1f} s) {lc[0]:.6f} {lc[1]:.6f}; launches {used}")
    if not all(math.isfinite(v) for v in lg + lc):
        fail("check: non-finite loss")
    for a_, b_ in zip(lg, lc):
        if abs(a_ - b_) > 2e-2 * abs(b_):   # bf16 products: 2% of the loss
            fail(f"check: card losses {lg} disagree with the CPU's {lc}")
    if min(v for k, v in used.items() if not k.endswith("_bwd")) == 0:
        fail(f"check: a kernel gate stayed closed at batch {CHECK_BATCH}: {used}")


def run_steps(torch, config, raw, device, steps, seed):
    """``steps`` train steps of a freshly initialised model: per-step host
    times (each ending in a synchronise), losses, the launch counters of
    those steps, the peak of max_memory_allocated, and a closure that takes
    one more step."""
    from point_dae_torch.engine.pretrain import init_model, make_train_step
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.utils import kernels

    model = init_model(config, seed=seed, device=device)
    state = TrainState.create(model, config, steps_per_epoch=100)
    step = make_train_step(model, config, device=device)
    g = torch.Generator(device=device).manual_seed(seed + 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = step(state, raw, generator=g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(m["loss_xyz"]), float(m["loss_normal"])))
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    for i, (lx, ln) in enumerate(losses):
        log(f"  step {i}: loss_xyz {lx:.6f} loss_global {ln:.6f} ({times[i] * 1e3:.1f} ms)")
    if not all(math.isfinite(v) for pair in losses for v in pair):
        fail("train: non-finite loss")
    steady = sorted(times[1:])
    steady = (steady[(len(steady) - 1) // 2] + steady[len(steady) // 2]) / 2
    return steady, times[0], launches, peak, lambda: step(state, raw, generator=g)


def phase_train(torch, config, raw, device, card):
    steady, first, launches, peak, one_more = run_steps(torch, config, raw, device,
                                                        TRAIN_STEPS, SEED)
    if min(launches.values()) == 0:
        fail(f"train: a kernel was never launched on the main path: {launches}")
    log(f"  launches on the main path ({TRAIN_STEPS} steps): {launches}")
    log(f"  [{card}] step {steady * 1e3:.2f} ms (median of steps 2-{TRAIN_STEPS}), "
        f"{BATCH / steady:.1f} clouds/s, first step {first * 1e3:.1f} ms, "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    profile_step(torch, one_more, card)
    del one_more
    torch.cuda.empty_cache()

    # the plain folding head (fold_impl xla) beside the kernel
    xla = copy.deepcopy(config)
    xla["model"]["transformer_config"]["fold_impl"] = "xla"
    log(f"  fold_impl xla, {XLA_STEPS} steps:")
    steady_x, _, launches_x, peak_x, one_more = run_steps(torch, xla, raw, device,
                                                          XLA_STEPS, SEED)
    if launches_x["folding_fwd"] or launches_x["folding_bwd"]:
        fail(f"train: fold_impl xla launched the folding kernel: {launches_x}")
    profile_step(torch, one_more, card, top=8)
    log(f"  [{card}] fold_impl auto (kernel) {steady * 1e3:.2f} ms a step, peak "
        f"{peak / 2 ** 30:.2f} GiB; fold_impl xla (plain head) {steady_x * 1e3:.2f} ms a step "
        f"(median of steps 2-{XLA_STEPS}), peak {peak_x / 2 ** 30:.2f} GiB")
    return launches


def profile_step(torch, run, card, top: int = 25) -> None:
    """Device time by kernel over one more step, under torch.profiler (which
    slows the host side, so the busy share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernel records only: operator records and annotations repeat their
    # kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(dev_us(e) for e in events)
    ours = {"mlp_ln": 0.0, "sum_partials": 0.0, "patchify_kernel": 0.0,
            "gather_rows_kernel": 0.0, "nn_half_small_kernel": 0.0,
            "fold_fwd_kernel": 0.0, "fold_bwd_rows_kernel": 0.0,
            "fold_bwd_weights_kernel": 0.0, "::gemm_kernel<": 0.0,
            "attention_fwd_kernel": 0.0, "attention_bwd_kernel": 0.0}
    for e in events:
        for k in ours:
            if k in e.key:
                ours[k] += dev_us(e)
    log(f"  [{card}] profiled step: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), ported kernels "
        + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in ours.items()))
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        log(f"    {dev_us(e) / 1e3:8.3f} ms {100 * dev_us(e) / busy:5.1f}% "
            f"x{e.count:<4d} {e.key[:110]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "point_dae_torch", "csrc")):
        fail(f"point_dae_torch/csrc not found next to {__file__}")
    sys.path.insert(0, root)
    from point_dae_torch.engine.pretrain import device_pipeline
    from point_dae_torch.utils import kernels
    from point_dae_torch.utils.config import ConfigDict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. card
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    logs = kernels.build()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line.lower() and "0 bytes" not in line:
                log(f"  {name}: {line.strip()}")

    config = ConfigDict(copy.deepcopy(FLAGSHIP_CONFIG))
    d = config["dataset"]["train"]["others"]
    g = torch.Generator(device=device).manual_seed(SEED)
    raw = torch.randn((BATCH, NRAW, 6), generator=g, device=device)
    _, clean = device_pipeline(raw, d["aug_type"], d["corrupt_type"], d["npoints"],
                               generator=g, device=device)
    pts = clean[..., :3].contiguous()

    # 3. kernels
    log("kernels:")
    records = phase_kernels(torch, pts, device)
    for name, r in records.items():
        log(f"  [{card}] {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}, "
            f"bound {r['bound'][0]:.4f} by {r['bound'][1]}) {r.get('note', '')}")

    # 4. check against the plain paths on the CPU
    log("check:")
    phase_check(torch, config, raw, device)

    # 5. train
    log("train:")
    launches = phase_train(torch, config, raw, device, card)

    out = []
    for name, r in records.items():
        out.append({"name": name, "route": "cuda", "source": r["source"],
                    "replaces": r["replaces"], "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
