"""Ablations of the EdgeConv kernels on one NVIDIA GPU.

Builds variants of two sources (nvcc, sm_90a, into ``build/edgeconv_ablation/``):

- ``tools/edgeconv_parent.cu``, the previous design (the backward scans the
  cloud's whole idx list for each target row; the selection keeps two
  query rows a warp), kept unchanged as the yardstick;
- ``csrc/edgeconv.cu``, the current design (the backward builds each
  cloud's contributor lists by a counting sort, then sums them; the
  selection stages a block's distances in shared memory).

Each variant removes one part of the work, so that the time of each part
shows: the backward's scan (parent) or its sort and sum launches (current,
split by launch), the selection's distances and its k rounds. A variant's
outputs are wrong by design; only its time is read, and nothing consumes
its outputs. At the DGCNN step's four shapes (B 128, N 1024, k 20, Cf / C
3 / 64, 64 / 64, 64 / 128, 128 / 256), at (32, 2048) and at (4, 4096) it
prints each part's device time (torch.profiler) and the time a call (CUDA
events), and holds the current kernels' idx and du against the parent's,
bit for bit.

    python3 -m point_dae_torch.tools.edgeconv_ablation
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import threading

K = 20
# (B, N, Cf, C)
SHAPES = ((128, 1024, 3, 64), (128, 1024, 64, 64), (128, 1024, 64, 128),
          (128, 1024, 128, 256), (32, 2048, 64, 64), (4, 4096, 64, 64))

_PARENT_SUM = "    for (int q = 0; q < n; ++q) {"
_PARENT_ROUNDS = "    for (int r = 0; r < k; ++r) {\n      float best[kR];"
_PARENT_CHANNELS = "    for (int cc = 0; cc < Cf; cc += kTileCh) {"
_CUR_ROUNDS = "    for (int r = 0; r < k; ++r) {\n      float best[kR];"
_CUR_CHANNELS = "  for (int g = 0; g < groups; ++g) {   // the same for the whole block"
_CUR_WARPS = "constexpr int kSumWarps = 2;"
_CUR_VEC = "  const int vec = C % 4 == 0 && C > 64 ? 4 : C % 2 == 0 ? 2 : 1;   // channels a lane"
_CUR_BATCH = "  constexpr int kBatch = 4;   // list entries whose rows are loaded together"
_CUR_MACS = """    // a channel at a time over all 32 sums: 32 independent chains
#pragma unroll
    for (int a = 0; a < kRT; ++a)
#pragma unroll
      for (int t = 0; t < kCT; ++t) acc[a][t] = mac_rn(acc[a][t], q[a].x, y[t].x);
#pragma unroll
    for (int a = 0; a < kRT; ++a)
#pragma unroll
      for (int t = 0; t < kCT; ++t) acc[a][t] = mac_rn(acc[a][t], q[a].y, y[t].y);
#pragma unroll
    for (int a = 0; a < kRT; ++a)
#pragma unroll
      for (int t = 0; t < kCT; ++t) acc[a][t] = mac_rn(acc[a][t], q[a].z, y[t].z);
#pragma unroll
    for (int a = 0; a < kRT; ++a)
#pragma unroll
      for (int t = 0; t < kCT; ++t) acc[a][t] = mac_rn(acc[a][t], q[a].w, y[t].w);
"""
_CUR_CHAIN = """#pragma unroll
    for (int t = 0; t < kCT; ++t)
#pragma unroll
      for (int a = 0; a < kRT; ++a) {
        float v = acc[a][t];
        v = mac_rn(v, q[a].x, y[t].x);
        v = mac_rn(v, q[a].y, y[t].y);
        v = mac_rn(v, q[a].z, y[t].z);
        acc[a][t] = mac_rn(v, q[a].w, y[t].w);
      }
"""

# name: (source, the change, replacements)
VARIANTS = {
    "parent": ("parent", "none", []),
    "parent_scan": ("parent", "each backward list sums its first contributor only: what "
                    "remains is the idx scan", [(_PARENT_SUM, _PARENT_SUM.replace(
                        "q < n", "q < min(n, 1)"))]),
    "parent_dist": ("parent", "one selection round instead of k: what remains is the "
                    "distances", [(_PARENT_ROUNDS, _PARENT_ROUNDS.replace(
                        "r < k", "r < min(k, 1)"))]),
    "parent_rounds": ("parent", "no channel loop (the distances are sq[i] + sq[j]): what "
                      "remains is the k rounds", [(_PARENT_CHANNELS, _PARENT_CHANNELS.replace(
                          "cc < Cf", "cc < 0"))]),
    "current_dist": ("current", "one selection round instead of k: what remains is the "
                     "distances", [(_CUR_ROUNDS, _CUR_ROUNDS.replace("r < k", "r < min(k, 1)"))]),
    "current_rounds": ("current", "no multiply-adds (the distances are sq[i] + sq[j]; the "
                       "tiles still staged): what remains is the k rounds and the tile ring",
                       [(_CUR_CHANNELS, _CUR_CHANNELS.replace("g < groups", "g < 0"))]),
    "current_chains": ("current", "each sum takes a group's four channels in a row (four "
                       "dependent adds) before the next sum", [(_CUR_MACS, _CUR_CHAIN)]),
    "current_warps8": ("current", "sum pass in blocks of eight warps",
                       [(_CUR_WARPS, _CUR_WARPS.replace("2;", "8;"))]),
    "current_vec2": ("current", "sum pass with two channels a lane at every even C",
                     [(_CUR_VEC, _CUR_VEC.replace("C % 4 == 0 && C > 64 ? 4 : ", ""))]),
    "current_batch8": ("current", "sum pass with batches of eight entries",
                       [(_CUR_BATCH, _CUR_BATCH.replace("= 4;", "= 8;"))]),
}

P, I = ctypes.c_void_p, ctypes.c_int
# the previous design's C entries
PARENT_ARGTYPES = {
    "edgeconv_fwd": [P, P, P] + [I] * 6 + [P] * 8,
    "knn_select": [P] * 4 + [I] * 5 + [P] * 3,
    "edgeconv_bwd_first": [P] * 8 + [I] * 4 + [P, P],
    "edgeconv_bwd_split": [P] * 10 + [I] * 4 + [P, P],
}


def _paths():
    from point_dae_torch.utils import kernels

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "edgeconv_ablation")
    return {"parent": os.path.join(here, "edgeconv_parent.cu"),
            "current": os.path.join(kernels.CSRC, "edgeconv.cu")}, out_dir


def variant_sources(names) -> dict:
    """The text of each named variant; raises if a source no longer holds
    a line a variant replaces."""
    srcs, _ = _paths()
    texts = {}
    for name in names:
        which, _, reps = VARIANTS[name]
        text = open(srcs[which]).read()
        for old, new in reps:
            if old not in text:
                raise SystemExit(f"{name}: {os.path.basename(srcs[which])} no longer has "
                                 f"{old[:60]!r}")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def build(names) -> dict:
    """Compile the named variants, one nvcc each, all at once: {name:
    (ctypes library, nvcc's -Xptxas -v output)}."""
    from point_dae_torch.utils import kernels

    texts = variant_sources(names)
    _, out_dir = _paths()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    try:
        for name, text in texts.items():
            path = os.path.join(out_dir, f"{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            lib = os.path.join(out_dir, f"lib{name}.so")
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-o", lib, path]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), lib)
        libs = {}
        for name, (proc, lib) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-3000:]}")
            libs[name] = (ctypes.CDLL(lib), log)
        return libs
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build_in_background(names):
    """Start ``build(names)`` on a thread; the returned function joins it
    and returns the libraries (or raises the build's error)."""
    box = {}

    def run():
        try:
            box["libs"] = build(names)
        except BaseException as e:  # handed to the caller on join
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def join():
        t.join()
        if "err" in box:
            raise box["err"]
        return box["libs"]

    return join


def entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = PARENT_ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def checked(call):
    err = call()
    if err != 0:
        raise RuntimeError(f"a variant failed to launch ({err})")


def parent_bwd(lib, mode, U, idx, a, c, gM, gm, gs1, gs2):
    """du of the previous design's backward ``mode`` on the same inputs as
    ``ops.edgeconv.knn_aggregate_bwd_kernel``."""
    import torch

    B, N, C = U.shape
    k = idx.shape[-1]
    du = torch.empty_like(U)
    s = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (U, idx, a, c, gM, gm, gs1, gs2)]
    if mode == "first":
        checked(lambda: entry(lib, "edgeconv_bwd_first")(*ptrs, B, N, C, k, du.data_ptr(), s))
    else:
        wM, wm = torch.empty_like(U), torch.empty_like(U)
        checked(lambda: entry(lib, "edgeconv_bwd_split")(
            *ptrs, wM.data_ptr(), wm.data_ptr(), B, N, C, k, du.data_ptr(), s))
    return du


def parent_select(lib, xf, k):
    """(dists, idx) of the previous design's selection of each point's k
    nearest in its own cloud (the knn_select entry)."""
    import torch

    B, N, Cf = xf.shape
    d = torch.empty((B, N, k), device=xf.device)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=xf.device)
    sq = torch.empty((2, B, N), device=xf.device)
    checked(lambda: entry(lib, "knn_select")(
        xf.data_ptr(), xf.data_ptr(), sq[0].data_ptr(), sq[1].data_ptr(), B, N, N, Cf, k,
        d.data_ptr(), idx.data_ptr(), torch.cuda.current_stream().cuda_stream))
    return d, idx


def cuda_ms(fn, iters):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def by_launch(fn, groups, calls=5):
    """Device milliseconds a call by kernel-name group (torch.profiler);
    raises when the window recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {g: 0.0 for g in groups}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        grp = next((g for g, pat in groups.items() if re.search(pat, e.key)), None)
        if grp is not None:
            out[grp] += us / calls / 1e3
    if not sum(out.values()) > 0:
        raise RuntimeError(f"no device time recorded for {sorted(groups)}")
    return out


SELECT = {"select": r"knn_select_kernel|edgeconv_select|row_sqnorm"}
FWD = {"select": r"knn_select_kernel|edgeconv_select|row_sqnorm",
       "aggregate": r"edgeconv_aggregate_kernel"}
BWD = {"ties": r"tie_weights", "sort": r"contrib_", "sum": r"edgeconv_bwd"}


def inputs(torch, B, N, Cf, C, g):
    """xf with duplicated rows (distance ties), U of bf16 values with the
    same duplicates (value ties), four cotangents."""
    dev = g.device
    xf = torch.randn((B, N, Cf), generator=g, device=dev)
    xf[:, N - 64:] = xf[:, :64]
    U = torch.randn((B, N, C), generator=g, device=dev).bfloat16().float()
    U[:, N - 64:] = U[:, :64]
    cots = [torch.randn((B, N, C), generator=g, device=dev) for _ in range(4)]
    return xf.contiguous(), U.contiguous(), cots


def main() -> None:
    import torch

    from point_dae_torch.ops import edgeconv, tiled_knn
    from point_dae_torch.utils import kernels

    if not torch.cuda.is_available():
        raise SystemExit("edgeconv_ablation needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    names = [n for n in VARIANTS if len(sys.argv) < 2 or n.startswith(tuple(sys.argv[1:]))]
    join = build_in_background(names)
    kernels.build(["edgeconv"])
    libs = join()
    for name, (_, log) in libs.items():
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)), key=int)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)), key=int)
        print(f"{name}: registers {regs}, spill stores {spills} B "
              f"({VARIANTS[name][1]})", flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)
    for B, N, Cf, C in SHAPES:
        xf, U, cots = inputs(torch, B, N, Cf, C, g)
        M, m, S1, S2, idx, rM, rm = edgeconv.knn_aggregate_fwd_kernel(U, xf, K, True)
        line = [f"({B}, {N}, Cf {Cf}, C {C})"]
        if "parent" in libs:
            lib = libs["parent"][0]
            _, pidx = parent_select(lib, xf, K)
            same_idx = torch.equal(pidx, idx)
            same = {mode: torch.equal(parent_bwd(lib, mode, U, idx, a, c, *cots),
                                      edgeconv.knn_aggregate_bwd_kernel(mode, U, idx, a, c,
                                                                        *cots))
                    for mode, a, c in (("first", rM, rm), ("split", M, m))}
            line.append(f"current against parent: idx equal {same_idx}, du first bit for bit "
                        f"{same['first']}, du split bit for bit {same['split']}")
        for name, (lib, _) in libs.items():
            if name.startswith("parent"):
                sel = lambda: parent_select(lib, xf, K)  # noqa: E731
                first = lambda: parent_bwd(lib, "first", U, idx, rM, rm, *cots)  # noqa: E731
                split = lambda: parent_bwd(lib, "split", U, idx, M, m, *cots)  # noqa: E731
                parts = [("select", by_launch(sel, SELECT)["select"])]
                if name in ("parent", "parent_scan"):
                    parts += [("bwd first", by_launch(first, BWD)["sum"]),
                              ("bwd split", sum(by_launch(split, BWD).values()))]
            else:
                kernels._libs["edgeconv"] = lib   # the wrappers launch the variant
                kernels._fns.clear()
                try:
                    parts = [("select", by_launch(
                        lambda: tiled_knn.knn_kernel(xf, xf, K), SELECT)["select"])]
                    for mode, a, c in (("first", rM, rm), ("split", M, m)):
                        parts.append((f"{mode} sum", by_launch(
                            lambda: edgeconv.knn_aggregate_bwd_kernel(mode, U, idx, a, c,
                                                                      *cots), BWD)["sum"]))
                finally:
                    kernels._libs.pop("edgeconv")
                    kernels._fns.clear()
            line.append(f"{name}: " + ", ".join(f"{p} {v:.4f}" for p, v in parts))
        fwd = by_launch(lambda: edgeconv.knn_aggregate_fwd_kernel(U, xf, K, True), FWD)
        first = by_launch(lambda: edgeconv.knn_aggregate_bwd_kernel(
            "first", U, idx, rM, rm, *cots), BWD)
        split = by_launch(lambda: edgeconv.knn_aggregate_bwd_kernel(
            "split", U, idx, M, m, *cots), BWD)
        line.append("current: fwd " + ", ".join(f"{p} {v:.4f}" for p, v in fwd.items())
                    + "; bwd first " + ", ".join(f"{p} {v:.4f}" for p, v in first.items())
                    + "; bwd split " + ", ".join(f"{p} {v:.4f}" for p, v in split.items())
                    + f"; a call (CUDA events): fwd "
                    f"{cuda_ms(lambda: edgeconv.knn_aggregate_fwd_kernel(U, xf, K, True), 5):.4f}"
                    f", first {cuda_ms(lambda: edgeconv.knn_aggregate_bwd_kernel('first', U, idx, rM, rm, *cots), 5):.4f}")
        print("\n  ".join(line) + "  (device ms a call)", flush=True)
        del xf, U, cots, M, m, S1, S2, idx, rM, rm
        torch.cuda.empty_cache()

    # the SM clock while the selection at Cf 128 runs: about a second of
    # launches queued, then nvidia-smi reads the card mid-run
    xf = torch.randn((128, 1024, 128), generator=g, device="cuda")
    tiled_knn.knn_kernel(xf, xf, K)
    torch.cuda.synchronize()
    for _ in range(400):
        tiled_knn.knn_kernel(xf, xf, K)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip()
    torch.cuda.synchronize()
    print(f"under the selection at (128, 1024, Cf 128): SM clock, its maximum, power: {clocks}",
          flush=True)


if __name__ == "__main__":
    main()
