"""Ablations of the MLP kernels (``csrc/mlp.cu``) on one NVIDIA GPU.

Builds variants of ``csrc/mlp.cu`` (nvcc, sm_90a, into
``build/mlp_ablation/``), each with one change that removes a part of the
work of the backward's dual product (the first GEMM of the backward, whose
epilogue applies GELU) or of the forward's hidden product (whose epilogue
applies GELU and stores the bf16 hidden), and times the ``mlp`` backward
and the ``mlp_ln`` and ``mlp`` forwards at the flagship shape (R 16384, C
384, H 1536): each one's time a call (CUDA events) and the device time of
each of its launches (torch.profiler). A variant's outputs are wrong by
design; only its time is read. Every variant keeps the accumulators in
use: a product whose results nobody reads is dropped by the compiler.

    python3 -m point_dae_torch.tools.mlp_ablation
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess

GELU = ("  a = h * cdf;  // = gelu(h) to the bit: halving is exact\n"
        "  d = cdf + h * 0.3989422804014327f * expf(-0.5f * h * h);")
CDF = "  const float cdf = 0.5f * (1.0f + erff(h * 0.70710678118654752f));\n"
COPY_OUT = """      *reinterpret_cast<uint4*>(out + size_t(row) * p.ldo + col) =
          *reinterpret_cast<const uint4*>((second ? s_a : s_dh) + r * LDS + c);"""
SECOND = """      if constexpr (G::DUAL)
        wgmma_m64n128k16<0, 0>(acc2, op_desc<false>(a + 2 * G::OP, kk),
                               op_desc<false>(b + 2 * G::OP, kk));"""
FWD_GELU = "  return h * (0.5f * (1.0f + erff(h * 0.70710678118654752f)));"
FWD_STORE = """      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + size_t(row) * p.ldo + col) =
          *reinterpret_cast<const uint4*>(s_h + r * LDS + c);"""

# name: (the change, replacements)
VARIANTS = {
    "base": ("none", []),
    "fast_exp": ("expf in the GELU derivative replaced by the __expf intrinsic",
                 [(GELU, GELU.replace("expf(", "__expf("))]),
    "no_gelu": ("the epilogue's GELU and its derivative replaced by a = h, d = 1 (no erff, "
                "no expf)", [(CDF + GELU, "  a = h;\n  d = 1.f;")]),
    "no_copy_out": ("the epilogue's 16-byte copies of bf16(dh) and bf16(GELU(h)) from shared "
                    "to device memory dropped (staging and db1 sums kept)", [(COPY_OUT, "")]),
    "one_product": ("the dual product's second GEMM (gbr k2^T) dropped: its accumulator "
                    "stays 0", [(SECOND, "")]),
    "fwd_no_gelu": ("the forward hidden's GELU replaced by a = h (no erff; bias and bf16 "
                    "staging kept)", [(FWD_GELU, "  return h;")]),
    "fwd_no_store": ("the forward hidden's 16-byte stores from shared to device memory "
                     "dropped (GELU and staging kept; the output product reads stale "
                     "memory)", [(FWD_STORE, "")]),
}


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from point_dae_torch.ops import mlp
    from point_dae_torch.utils import kernels

    if not torch.cuda.is_available():
        raise SystemExit("mlp_ablation needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    src = open(os.path.join(kernels.CSRC, "mlp.cu")).read()
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "mlp_ablation")
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for name, (_, reps) in VARIANTS.items():  # every variant checked before any build
        text = src
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"{name}: csrc/mlp.cu no longer has {old[:60]!r}")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    try:
        for name, (proc, lib) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed on variant {name}:\n{log[-3000:]}")
            regs = {k: re.search(k + r"[^\n]*sm_90a'\n(?:[^\n]*\n){0,3}?[^\n]*Used "
                                 r"(\d+) registers", log) for k in ("mlp_bwd_dual_kernel",
                                                                   "mlp_fwd_hidden_kernel")}
            libs[name] = (ctypes.CDLL(lib), {k.split("_")[1]: m.group(1) if m else "?"
                                             for k, m in regs.items()})
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    R, C, H = 16384, 384, 1536
    bf = torch.bfloat16
    x = torch.randn((R, C), generator=g, device=dev).to(bf)
    k1 = (torch.randn((C, H), generator=g, device=dev) / math.sqrt(C)).to(bf)
    b1 = 0.02 * torch.randn((H,), generator=g, device=dev)
    k2 = (torch.randn((H, C), generator=g, device=dev) / math.sqrt(H)).to(bf)
    cot = torch.randn((R, C), generator=g, device=dev)
    outs = [torch.empty((R, C), dtype=bf, device=dev), torch.empty((C, H), dtype=bf, device=dev),
            torch.empty((H, C), dtype=bf, device=dev), torch.empty((H,), device=dev),
            torch.empty((C,), device=dev)]
    S, scratch = mlp._bwd_scratch(R, C, H, dev)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ptrs = [t.data_ptr() for t in (x, k1, b1, k2, cot, *outs, *scratch)]
    # the forwards: mlp on x, mlp_ln on an f32 x with a row scale
    xf = torch.randn((R, C), generator=g, device=dev)
    gm = 1 + 0.1 * torch.randn((C,), generator=g, device=dev)
    bt = 0.05 * torch.randn((C,), generator=g, device=dev)
    b2 = 0.02 * torch.randn((C,), generator=g, device=dev)
    sc = ((torch.rand((R,), generator=g, device=dev) >= 0.1) / 0.9).float()
    y = torch.empty((R, C), device=dev)
    hin = torch.empty((R, C), dtype=bf, device=dev)
    act = torch.empty((R, H), dtype=bf, device=dev)
    fwd_ptrs = [t.data_ptr() for t in (x, k1, b1, k2, b2, y, act)]
    ln_ptrs = [t.data_ptr() for t in (xf, gm, bt, k1, b1, k2, b2, sc, y, hin, act)]

    def timed(call, iters):
        for _ in range(2):
            if call() != 0:
                raise SystemExit("a variant failed to launch")
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            call()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    def by_launch(call, calls=10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            m = re.search(r"mlp_(?:bwd|fwd)_([a-z_]+?)_kernel", e.key)
            if m and us > 0:
                out[m.group(1)] = out.get(m.group(1), 0.0) + us / calls / 1e3
        return out

    for name, (lib, regs) in libs.items():
        bwd, fwd, ln_fwd = lib.mlp_bwd, lib.mlp_fwd, lib.mlp_ln_fwd
        bwd.argtypes = [P] * 17 + [I] * 4 + [P]
        fwd.argtypes = [P] * 7 + [I] * 3 + [P]
        ln_fwd.argtypes = [P] * 11 + [I] * 3 + [F, P]
        calls = (("mlp_bwd", lambda: bwd(*ptrs, R, C, H, S, stream)),
                 ("mlp_ln_fwd", lambda: ln_fwd(*ln_ptrs, R, C, H, 1e-6, stream)),
                 ("mlp_fwd", lambda: fwd(*fwd_ptrs, R, C, H, stream)))
        for what, call in calls:
            ms = timed(call, 20)
            split = by_launch(call)
            print(f"{name:15s} {what:10s} {ms:.4f} ms a call; device "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + " ms", flush=True)
        print(f"{name:15s} registers: dual {regs['bwd']}, hidden {regs['fwd']} (change: "
              f"{VARIANTS[name][0]})", flush=True)


if __name__ == "__main__":
    main()
