"""Ablations of the fused folding kernels on one NVIDIA GPU.

Builds variants of ``csrc/folding.cu`` (nvcc, sm_90a, into
``build/fold_ablation/``), each with one change that removes a part of the
work, and times ``folding_fwd`` and ``folding_bwd`` at the flagship shape
(13056 tokens x 36 points, C = F = 384) with CUDA events. A variant's
outputs are wrong by design; only its time is read. Every variant keeps the
products' accumulators in use: a product whose results nobody reads is
dropped by the compiler, which would time the wrong thing.

    python3 -m point_dae_torch.tools.fold_ablation
"""
from __future__ import annotations

import ctypes
import os
import subprocess

A_LOAD = ("            uint32_t af[4];\n"
          "            ldsm_x4(af, s_x + (m * 16 + (lane & 15)) * ldx + k0 + 16 * kk + "
          "(lane >> 4) * 8);")
ONE_A = ("            uint32_t af[4] = {0u, 0u, 0u, 0u};\n"
         "            if (m == 0) ldsm_x4(af, s_x + (lane & 15) * ldx + k0 + 16 * kk + "
         "(lane >> 4) * 8);")
W_BUILD = "    if (chunk + 1 < last) build(info[cur ^ 1], buf + (cur ^ 1) * 2 * KR * LDT);"
W_LOADS = ("          sv[i] = *reinterpret_cast<const float2*>(spc + tp.x);\n"
           "          if (!stage) gv[i] = bf2_to_f2(gpc + tp.y);")
W_NOLOADS = ("          sv[i] = make_float2(__int_as_float(tp.x), 1.f);\n"
             "          if (!stage) gv[i] = make_float2(__int_as_float(tp.y), 1.f);")
FIT = "static_assert(Layout(F_ONE_BLOCK, true).bytes <= 232448"

# name: (the change, replacements)
VARIANTS = {
    "base": ("none", []),
    "one_A_fragment": ("four of the five A-fragment loads of a k16 step dropped in every "
                       "product: each row fragment multiplies the first", [(A_LOAD, ONE_A)]),
    "ring_4_stages": ("a fourth stage in the weight ring (F 384 only)",
                      [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),
                       (FIT, "static_assert(true || Layout(F_ONE_BLOCK, true).bytes <= 232448")]),
    "no_weights_rebuild": ("the weights pass's elementwise rebuild of its slabs dropped",
                           [(W_BUILD, "")]),
    "no_weights_loads": ("the global loads (sp, gp1) of that rebuild dropped",
                         [(W_LOADS, W_NOLOADS)]),
}


def main() -> None:
    import torch

    from point_dae_torch.utils import kernels

    if not torch.cuda.is_available():
        raise SystemExit("fold_ablation needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    src = open(os.path.join(kernels.CSRC, "folding.cu")).read()
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "fold_ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (_, reps) in VARIANTS.items():
        text = src
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"{name}: csrc/folding.cu no longer has {old[:60]!r}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(lib)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    T, C, F, n = 13056, 384, 384, 36
    R = T * n
    bf = torch.bfloat16

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    xb, ksc, gp1 = rnd((T, C)).to(bf), rnd((C, 2 * F), 0.05).to(bf), rnd((n, F)).to(bf)
    k11, k12 = rnd((F, F), 0.05).to(bf), rnd((F, F), 0.05).to(bf)
    small, cot = rnd((13 * F + 8,), 0.1), rnd((R, 3))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, parts = 2 * sms, max(1, 2 * sms // (2 * (F // 128) ** 2))
    na = n * F + 12 * F + 4

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    fwd_bufs = [empty((T, 2 * F)), empty((R, 3))]
    bwd_bufs = [empty((T, 2 * F)), empty((R, 4)), empty((R, 4)), empty((R, F // 32), torch.int32),
                empty((R, F // 32), torch.int32), empty((blocks, 80, F), bf),
                empty((T, 2 * F), bf), torch.zeros((blocks, na), device=dev),
                empty((2, parts, F, F)), empty((4, max(C * 2 * F, F * F))), empty((T, C)),
                empty((C, 2 * F)), empty((na,)), empty((2, F, F))]
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int

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

    for name, lib in libs.items():
        fwd, bwd = lib.folding_fwd, lib.folding_bwd
        fwd.argtypes = [P] * 8 + [I] * 4 + [P]
        bwd.argtypes = [P] * 21 + [I] * 6 + [P]
        head = [t.data_ptr() for t in (xb, ksc, gp1, k11, k12, small)]
        f_ms = timed(lambda: fwd(*head, *(t.data_ptr() for t in fwd_bufs), T, C, F, n,
                                 stream), 10)
        b_ms = timed(lambda: bwd(*head, cot.data_ptr(), *(t.data_ptr() for t in bwd_bufs),
                                 T, C, F, n, blocks, parts, stream), 5)
        print(f"{name:20s} folding_fwd {f_ms:.4f} ms  folding_bwd {b_ms:.4f} ms  "
              f"(change: {VARIANTS[name][0]})", flush=True)


if __name__ == "__main__":
    main()
