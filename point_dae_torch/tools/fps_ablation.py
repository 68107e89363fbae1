"""Ablations of the FPS loop (``csrc/fps_loop.cuh``) and the fused patchify
(``csrc/patchify.cu``) on one NVIDIA GPU.

Builds (nvcc, sm_90a, into ``build/fps_ablation/<variant>/``):

- ``tools/fps_parent.cu`` and ``tools/patchify_parent.cu``, the previous
  designs (one block of 1024 threads a cloud with a shuffle argmax; patchify
  in one block a cloud with S rounds over all points a kNN row), kept
  unchanged as the yardsticks;
- ``csrc/fps.cu`` as it is, and two variants of it whose loop lacks one part
  of an iteration: ``no_update`` (each thread proposes its first point, with
  no distance update: what remains is the reduction, the barrier and the
  merge, the floor of an iteration) and ``no_reduce`` (each thread takes its
  own candidate as the next pick: no warp reduction, no slots, no barrier;
  what remains is the update's issue). A variant's picks are wrong by design;
  only its time is read.

At the fine-tune paths' FPS shapes it prints each design's and variant's
time a call (CUDA events) and per iteration, the current kernel under every
cluster size (and two block widths at each), each held bit for bit against
the previous design; the clusters the card holds at once; and at the paths'
patchify shapes the two launches apart (torch.profiler), fps_idx and knn_idx
bit for bit against the previous design.

    python3 -m point_dae_torch.tools.fps_ablation
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

# (B, N, n): the DGCNN fine-tune train step (and its vote draws), its eval
# step, fine-tune A and C's resample, a cloud in the per-row gate, a cloud
# past one block's registers
FPS_SHAPES = ((32, 8192, 1200), (32, 8192, 1024), (32, 2048, 2048), (32, 1200, 1024),
              (32, 16384, 1024))
# (B, N, G, S): the flagship step, PT part segmentation, fine-tune A
PATCHIFY_SHAPES = ((256, 1024, 64, 32), (16, 2048, 128, 32), (32, 2048, 128, 32))

_UPDATE = ("#pragma unroll\n    for (int j = 0; j < PPT; ++j)\n      md[j] = fminf(",
           "    thread_best(md, best, jb);\n")
# the block's reduction and the cluster's exchange, from the warp's maximum to
# the winner's coordinates
_REDUCE = ("    const int b = it & 1;\n    warp_slot(", "      p = st.cand_pt[b][src];\n    }\n")

# name: (source, the change, replacements in fps_loop.cuh)
VARIANTS = {
    "fps_parent": ("tools/fps_parent.cu", "the previous design", []),
    "patchify_parent": ("tools/patchify_parent.cu", "the previous design", []),
    "current": ("csrc/fps.cu", "none", []),
    "no_update": ("csrc/fps.cu", "no distance update: each thread proposes its first point "
                  "(the reduction, barrier and merge alone)",
                  [(_UPDATE,
                    "    int best = __float_as_int(md[0]) ^ __float_as_int(px), jb = 0;\n")]),
    "no_reduce": ("csrc/fps.cu", "no reduction and no exchange: each thread takes its own "
                  "candidate as the next pick (the update's issue alone)",
                  [(_REDUCE, "    unsigned w = mine;\n    float4 p = spts[jb * nt + tid];\n")]),
}
P, I = ctypes.c_void_p, ctypes.c_int


def _paths():
    from point_dae_torch.utils import kernels

    pkg = os.path.dirname(kernels.CSRC)
    return pkg, kernels.CSRC, os.path.join(os.path.dirname(kernels.BUILD_DIR), "fps_ablation")


def build(names) -> dict:
    """Compile the named variants, one nvcc each, all at once: {name:
    (ctypes library, nvcc's -Xptxas -v output)}. A variant's sources go to
    its own directory, so that its fps_loop.cuh is the one it includes."""
    from point_dae_torch.utils import kernels

    pkg, csrc, out_dir = _paths()
    procs = {}
    try:
        for name in names:
            src, _, reps = VARIANTS[name]
            vdir = os.path.join(out_dir, name)
            os.makedirs(vdir, exist_ok=True)
            loop = open(os.path.join(csrc, "fps_loop.cuh")).read()
            for old, new in reps:   # old: a text, or (first line, last line) of a span
                first, last = (old, old) if isinstance(old, str) else old
                i = loop.find(first)
                j = loop.find(last, i)
                if i < 0 or j < 0:
                    raise SystemExit(f"{name}: fps_loop.cuh no longer has {first[:60]!r}")
                loop = loop[:i] + new + loop[j + len(last):]
            with open(os.path.join(vdir, "fps_loop.cuh"), "w") as f:
                f.write(loop)
            path = os.path.join(vdir, os.path.basename(src))
            with open(path, "w") as f:
                f.write(open(os.path.join(pkg, src)).read())
            lib = os.path.join(vdir, f"lib{name}.so")
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", csrc, "-o", lib, path]
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


def _checked(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"a variant failed to launch ({err})")


def parent_fps(lib, pts, n):
    """Picks of the previous FPS design (its buf: the streamed form's
    scratch above 8192 points)."""
    import torch

    B, N, _ = pts.shape
    fn = lib.fps
    fn.argtypes = [P, I, I, I, P, P, P]
    fn.restype = I
    out = torch.empty((B, n), dtype=torch.int32, device=pts.device)
    buf = torch.empty((B, N, 4), device=pts.device) if N > 8192 else None
    _checked(fn(pts.data_ptr(), B, N, n, 0 if buf is None else buf.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream().cuda_stream))
    return out


def parent_patchify(lib, pts, G, S):
    """(fps_idx, knn_idx) of the previous patchify design."""
    import torch

    B, N, _ = pts.shape
    fn = lib.patchify
    fn.argtypes = [P, I, I, I, I, P, P, P]
    fn.restype = I
    fps_idx = torch.empty((B, G), dtype=torch.int32, device=pts.device)
    knn_idx = torch.empty((B, G, S), dtype=torch.int32, device=pts.device)
    _checked(fn(pts.data_ptr(), B, N, G, S, fps_idx.data_ptr(), knn_idx.data_ptr(),
                torch.cuda.current_stream().cuda_stream))
    return fps_idx, knn_idx


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


def with_library(name, lib, fn):
    """fn() with the port's ``name`` library replaced by ``lib``."""
    from point_dae_torch.utils import kernels

    kernels._libs[name] = lib
    kernels._fns.clear()
    try:
        return fn()
    finally:
        kernels._libs.pop(name)
        kernels._fns.clear()


def cluster_plans(N):
    """At each cluster size whose registers hold N points: the plan's block
    (``fps.block_shape``) and the block of twice as many threads with half
    the points a thread (or half as many with twice, at 256 threads)."""
    from point_dae_torch.ops import fps

    out = []
    for c in fps.CLUSTERS:
        if c * fps.BLOCK_POINTS < N:
            continue
        threads, ppt = fps.block_shape(-(-N // c))
        out.append(fps.FpsPlan(c, threads, ppt))
        if ppt > fps.PPTS[0] and 2 * threads <= fps.BLOCK_THREADS:
            out.append(fps.FpsPlan(c, 2 * threads, ppt // 2))
        elif ppt < fps.PPTS[-1] and threads > 32:
            out.append(fps.FpsPlan(c, -(-threads // 64) * 32, 2 * ppt))
    return out


def main() -> None:
    import torch

    from point_dae_torch.ops import fps, patchify
    from point_dae_torch.utils import kernels

    if not torch.cuda.is_available():
        raise SystemExit("fps_ablation needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    names = [n for n in VARIANTS if len(sys.argv) < 2 or n.startswith(tuple(sys.argv[1:]))]
    kernels.build(["fps", "patchify"])
    libs = build(names)
    for name, (_, log) in libs.items():
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)), key=int)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)), key=int)
        print(f"{name}: registers {regs}, spill stores {spills} B ({VARIANTS[name][1]})",
              flush=True)
    dev = torch.device("cuda")
    sms, slots = fps.card(dev)
    print(f"{sms} SMs; clusters the card holds at once (256 threads, 128 KiB of shared "
          f"memory a block): " + ", ".join(f"{c}: {slots(c, 256, 32)}" for c in (2, 4, 8)),
          flush=True)

    g = torch.Generator(device=dev).manual_seed(0)
    for B, N, n in FPS_SHAPES:
        pts = torch.randn((B, N, 3), generator=g, device=dev)
        pts[:, N // 2:N // 2 + N // 16] = pts[:, :N // 16]     # duplicated points
        pts[:, 5:9] = 0.0                                      # never selectable
        p = fps.plan(B, N, sms, slots)
        want = (parent_fps(libs["fps_parent"][0], pts, n) if "fps_parent" in libs
                else fps.fps_kernel(pts, n))
        line = [f"fps ({B}, {N}) -> {n}, plan {tuple(p)} ({p.form}):"]
        if "fps_parent" in libs:
            ms = cuda_ms(lambda: parent_fps(libs["fps_parent"][0], pts, n), 5)
            line.append(f"parent {ms:.4f} ms ({ms / (n - 1) * 1e3:.3f} us an iteration)")
        for q in cluster_plans(N):
            same = torch.equal(fps.fps_kernel(pts, n, use_plan=q), want)
            ms = cuda_ms(lambda: fps.fps_kernel(pts, n, use_plan=q), 5)
            line.append(f"current {tuple(q)} {ms:.4f} ms ({ms / (n - 1) * 1e3:.3f} us an "
                        f"iteration), picks equal to the parent's {same}")
        for name in ("no_update", "no_reduce"):
            if name in libs:
                ms = with_library("fps", libs[name][0], lambda: cuda_ms(
                    lambda: fps.fps_kernel(pts, n, use_plan=p), 5))
                line.append(f"{name} {ms:.4f} ms ({ms / (n - 1) * 1e3:.3f} us an iteration)")
        print("\n  ".join(line), flush=True)
        del pts
        torch.cuda.empty_cache()

    groups = {"fps": r"patchify_fps_", "knn": r"patchify_knn_", "parent": r"patchify_kernel"}
    for B, N, G, S in PATCHIFY_SHAPES:
        pts = torch.randn((B, N, 3), generator=g, device=dev)
        line = [f"patchify ({B}, {N}), G {G}, S {S}, plan {tuple(fps.plan(B, N, sms, slots))}:"]
        fk, kk = patchify.fused_patchify(pts, G, S)
        if "patchify_parent" in libs:
            lib = libs["patchify_parent"][0]
            fp, kp = parent_patchify(lib, pts, G, S)

            def parent():
                return parent_patchify(lib, pts, G, S)

            line.append(f"fps_idx equal to the parent's {torch.equal(fk, fp)}, knn_idx "
                        f"{torch.equal(kk, kp)}; parent {cuda_ms(parent, 10):.4f} ms, device "
                        f"{by_launch(parent, groups)['parent']:.4f}")
        dev_ms = by_launch(lambda: patchify.fused_patchify(pts, G, S), groups)
        line.append(f"current {cuda_ms(lambda: patchify.fused_patchify(pts, G, S), 10):.4f} "
                    f"ms, device: fps {dev_ms['fps']:.4f}, knn rows {dev_ms['knn']:.4f}")
        print("\n  ".join(line), flush=True)


if __name__ == "__main__":
    main()
