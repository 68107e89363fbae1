"""Ablations of the two chamfer kernels (``csrc/chamfer.cu``) on one NVIDIA
GPU.

Builds (nvcc, sm_90a, into ``build/chamfer_ablation/``):

- ``tools/chamfer_parent.cu``, the previous design (a warp a patch for the
  patch half; a thread a row over 1024-point tiles for the tiled half; one
  launch a direction), kept unchanged as the yardstick;
- variants of ``csrc/chamfer.cu``: the tiled half recording chunks of 8 or
  32 columns (``chunk8``, ``chunk32``) or without its rescan
  (``tiled_no_rescan``); the patch half without reading x and y, without
  storing, without its index (``patch_no_load``, ``patch_no_store``,
  ``patch_no_index``), with two or four queries a thread, its scan unrolled
  further, its registers capped for six blocks an SM.

At the DGCNN step's tiled shape (128 x 1024 x 1024, both directions) and
the flagship's patch shape (13056 patches of 36 and 32 points, both
directions) it holds the current kernels bit for bit against the plain
halves and the previous design, and prints the device time (torch.profiler)
of the previous design, of the current one under its plan and under the
plans around it, the SM clock under load, and of each variant (the no_*
variants lack a part: their outputs are wrong by design, only their time is
read); then the tiled kernel at three gate shapes of few rows a cloud under
its plan and in one column group. Every time beside the card's name and
power limit.

    python3 -m point_dae_torch.tools.chamfer_ablation
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import sys

_CHUNK = "constexpr int kChunk = 16;"
_LOAD = "      v[u] = e < nx ? xb[e] : e < total ? yb[e - nx] : 0.f;"
_SCAN = "    int j = 0;\n    for (; j + 4 <= nt; j += 4) {"
_STORE = "        dist[o] = md[i];"
_RESCAN = "      if (bc[r] >= 0) {"
_INDEX = "  mi = d < md ? j : mi;\n"
_QUERIES = "constexpr int kQueries = 3;"
_BOUNDS = "__launch_bounds__(kMaxPatchThreads)\nnn_half_small_kernel"
# name: (source, the change, replacements). The no_* variants lack one part
# of a kernel: their outputs are wrong by design, only their time is read.
VARIANTS = {
    "chamfer_parent": ("tools/chamfer_parent.cu", "the previous design", []),
    "chunk8": ("csrc/chamfer.cu", "tiled half: chunks of 8 columns",
               [(_CHUNK, _CHUNK.replace("16;", "8;"))]),
    "chunk32": ("csrc/chamfer.cu", "tiled half: chunks of 32 columns",
                [(_CHUNK, _CHUNK.replace("16;", "32;"))]),
    "tiled_no_rescan": ("csrc/chamfer.cu", "tiled half without the rescan of recorded chunks",
                        [(_RESCAN, "      if (bc[r] >= 1 << 30) {")]),
    "patch_no_load": ("csrc/chamfer.cu", "patch half: shared memory filled without reading "
                      "x and y", [(_LOAD, "      v[u] = 1e-3f * e;")]),
    "patch_no_store": ("csrc/chamfer.cu", "patch half: no output stored",
                       [(_STORE, "        if (md[i] != 12345.f) continue;\n" + _STORE)]),
    "patch_no_index": ("csrc/chamfer.cu", "patch half: no index kept in the scan (fminf alone)",
                       [(_INDEX, "")]),
    "patch_queries2": ("csrc/chamfer.cu", "patch half: two queries a thread",
                       [(_QUERIES, _QUERIES.replace("3;", "2;"))]),
    "patch_queries4": ("csrc/chamfer.cu", "patch half: four queries a thread",
                       [(_QUERIES, _QUERIES.replace("3;", "4;"))]),
    "patch_unroll2": ("csrc/chamfer.cu", "patch half: the scan unrolled to eight targets",
                      [(_SCAN, _SCAN.replace("    for", "#pragma unroll 2\n    for"))]),
    "patch_minblocks6": ("csrc/chamfer.cu", "patch half: registers capped for six blocks an SM",
                         [(_BOUNDS, _BOUNDS.replace("Threads)", "Threads, 6)"))]),
}
# queries a thread of the patch variants that scan another number of them;
# each runs under a plan of one round of its own tasks a block
QUERIES = {"patch_queries2": 2, "patch_queries4": 4}
P, I = ctypes.c_void_p, ctypes.c_int
# (B, N, M) inside the tiled gate and off the paths, of few rows a cloud
OFF_PATH = ((3, 700, 1500), (2, 512, 512), (4, 1023, 2049))
GROUPS = {"chamfer": r"nn_half"}


def build(names) -> dict:
    """Compile the named variants, one nvcc each, all at once: {name:
    (ctypes library, nvcc's -Xptxas -v output)}."""
    from point_dae_torch.utils import kernels

    pkg = os.path.dirname(kernels.CSRC)
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "chamfer_ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    try:
        for name in names:
            src, _, reps = VARIANTS[name]
            text = open(os.path.join(pkg, src)).read()
            for old, new in reps:
                if old not in text:
                    raise SystemExit(f"{name}: {src} no longer has {old[:60]!r}")
                text = text.replace(old, new)
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


def _checked(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"the previous chamfer design failed to launch ({err})")


def parent_tiled(lib, x, y):
    """(dist, idx) of the previous tiled design, x's points in y."""
    import torch

    B, N, _ = x.shape
    fn = lib.nn_half_tiled
    fn.argtypes = [P, P, I, I, I, P, P, P]
    fn.restype = I
    dist = torch.empty((B, N), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, N), dtype=torch.int32, device=x.device)
    _checked(fn(x.data_ptr(), y.data_ptr(), B, N, y.shape[1], dist.data_ptr(), idx.data_ptr(),
                torch.cuda.current_stream().cuda_stream))
    return dist, idx


def parent_small(lib, x, y):
    """(dist, idx, near) of the previous patch design, x's points in y."""
    import torch

    Pn, N, _ = x.shape
    fn = lib.nn_half_small
    fn.argtypes = [P, P, I, I, I, P, P, P, P]
    fn.restype = I
    dist = torch.empty((Pn, N), dtype=torch.float32, device=x.device)
    idx = torch.empty((Pn, N), dtype=torch.int32, device=x.device)
    near = torch.empty((Pn, N, 3), dtype=torch.float32, device=x.device)
    _checked(fn(x.data_ptr(), y.data_ptr(), Pn, N, y.shape[1], dist.data_ptr(), idx.data_ptr(),
                near.data_ptr(), torch.cuda.current_stream().cuda_stream))
    return dist, idx, near


def parent_pair(lib, x, y, small: bool):
    """Both directions of the previous design: two launches."""
    half = parent_small if small else parent_tiled
    return half(lib, x, y) + half(lib, y, x)


def inputs(torch, device, seed=0):
    """The paths' inputs: a DGCNN reconstruction against its clean cloud
    (128, 1024, 3) both ways, with exact hits; the flagship's patches, 36
    rebuilt points against 32 true ones (13056 patches of a 256-cloud
    batch's 51 masked patches), with ties."""
    g = torch.Generator(device=device).manual_seed(seed)
    clean = torch.randn((128, 1024, 3), generator=g, device=device)
    rec = clean + 0.05 * torch.randn(clean.shape, generator=g, device=device)
    rec[:, 7] = clean[:, 9]
    ty = 0.1 * torch.randn((13056, 32, 3), generator=g, device=device)
    tx = 0.05 * torch.randn((13056, 36, 3), generator=g, device=device)
    ty[:, 20] = ty[:, 3]
    return rec.contiguous(), clean.contiguous(), tx.contiguous(), ty.contiguous()


def clocks_under(fn, seconds: float = 2.0) -> str:
    """The SM clock and power draw nvidia-smi reads every 100 ms while fn
    runs back to back for ``seconds``: "min-max MHz, max W"."""
    import time

    import torch

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=10)
    rows = [line.split(",") for line in out.strip().splitlines() if line.count(",") == 1]
    mhz = [float(a) for a, _ in rows[2:]] or [math.nan]
    watts = [float(b) for _, b in rows[2:]] or [math.nan]
    return f"SM clock {min(mhz):.0f}-{max(mhz):.0f} MHz, up to {max(watts):.0f} W"


def main() -> None:
    import torch

    from point_dae_torch.losses import chamfer
    from point_dae_torch.tools.fps_ablation import cuda_ms, with_library
    from point_dae_torch.tools.rowreduce_ablation import by_launch
    from point_dae_torch.utils import kernels

    if not torch.cuda.is_available():
        raise SystemExit("chamfer_ablation needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    names = [n for n in VARIANTS if len(sys.argv) < 2 or n.startswith(tuple(sys.argv[1:]))]
    from point_dae_torch.tools.edgeconv_ablation import build_in_background

    join = build_in_background(names, build)
    logs = kernels.build(["chamfer"])
    libs = join()
    for name, log in list(logs.items()) + [(n, lg) for n, (_, lg) in libs.items()]:
        for fn, regs in re.findall(r"Compiling entry function '(\w*nn_half\w*)'"
                                   r"[\s\S]*?Used (\d+) registers", log):
            print(f"{name}: {re.search(r'nn_half_[a-z_]+(?:ILi\d+E)?', fn).group(0)} {regs} "
                  f"registers", flush=True)
    dev = torch.device("cuda")
    sms = kernels.card_sms(dev)
    parent = libs["chamfer_parent"][0] if "chamfer_parent" in libs else None
    rec, clean, tx, ty = inputs(torch, dev)

    def dev_ms(fn, calls=10):
        return by_launch(fn, GROUPS, calls)["chamfer"]

    for small, x, y in ((False, rec, clean), (True, tx, ty)):
        pair = chamfer.nn_half_small_pair if small else chamfer.nn_half_tiled_pair
        plain = chamfer.nn_half_small_plain if small else chamfer.nn_half_tiled_plain
        got = pair(x, y)
        want = plain(x, y) + plain(y, x)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        what = "patch" if small else "tiled"
        B, N, _ = x.shape
        M = y.shape[1]
        plan = chamfer.patch_plan(N, M) if small else chamfer.tiled_plan(B, N, M, sms)
        lines = [f"{what} ({B}, {N}, {M}) plan {tuple(plan)}: bit for bit with the plain "
                 f"halves {same}"]
        if parent is not None:
            prev = parent_pair(parent, x, y, small)
            previous = lambda: parent_pair(parent, x, y, small)  # noqa: E731
            lines.append(f"  previous design: device {dev_ms(previous):.4f} ms, "
                         f"{cuda_ms(previous, 20):.4f} a call; bit for bit "
                         f"{all(torch.equal(a, b) for a, b in zip(got, prev))}")
        cur_ms = dev_ms(lambda: pair(x, y))
        lines.append(f"  current: device {cur_ms:.4f} ms, "
                     f"{cuda_ms(lambda: pair(x, y), 20):.4f} a call; under load "
                     f"{clocks_under(lambda: pair(x, y))}")
        if small:
            t = chamfer.patch_groups(N) + chamfer.patch_groups(M)
            alts = [chamfer.PatchPlan(K, T) for T in (64, 128, 256)
                    for K in sorted({T // t - 1, T // t, 2 * (T // t)})]
        else:
            alts = [chamfer.TiledPlan(R, W, S, min(-(-max(N, M) // S), chamfer.TILED_STAGE // S))
                    for R in (2, 4, 8) for W in (4, 8) for S in (1, 2, 4) if W % S == 0]
        timed = []
        for p in alts:
            if p == plan:
                continue
            ok = all(torch.equal(a, b) for a, b in zip(pair(x, y, plan=p), got))
            timed.append((dev_ms(lambda: pair(x, y, plan=p), 5), p, ok))
        fastest = min(timed)[1] if timed and min(timed)[0] < cur_ms else plan
        lines.append("  other plans: " + ", ".join(
            f"{tuple(p)} {ms:.4f}{'' if ok else ' DIFFERS'}" for ms, p, ok in sorted(timed)))
        for vname in (("patch_no_load", "patch_no_store", "patch_no_index", "patch_queries2",
                       "patch_queries4", "patch_unroll2", "patch_minblocks6") if small else
                      ("chunk8", "chunk32", "tiled_no_rescan")):
            if vname in libs:
                vp = fastest
                if vname in QUERIES:
                    q = QUERIES[vname]
                    vp = chamfer.PatchPlan(fastest.threads // (-(-N // q) + -(-M // q)),
                                           fastest.threads)
                ok = with_library("chamfer", libs[vname][0], lambda: all(
                    torch.equal(a, b) for a, b in zip(pair(x, y, plan=vp), got)))
                ms = with_library("chamfer", libs[vname][0], lambda: dev_ms(
                    lambda: pair(x, y, plan=vp)))
                lines.append(f"  {vname} ({VARIANTS[vname][1]}) under {tuple(vp)}: device "
                             f"{ms:.4f} ms, bit for bit {ok}")
        print("\n".join(lines) + f" ({card})", flush=True)

    # off the path, inside the tiled gate: shapes of few rows, where the plan
    # splits the columns into groups, against one group
    g = torch.Generator(device=dev).manual_seed(1)
    for B, N, M in OFF_PATH:
        x = torch.randn((B, N, 3), generator=g, device=dev)
        y = torch.randn((B, M, 3), generator=g, device=dev)
        plan = chamfer.tiled_plan(B, N, M, sms)
        one = plan._replace(groups=1, piece=min(max(N, M), chamfer.TILED_STAGE))
        got = chamfer.nn_half_tiled_pair(x, y)
        same = all(torch.equal(a, b) for a, b in zip(got, chamfer.nn_half_tiled_pair(x, y, one)))
        print(f"tiled ({B}, {N}, {M}) plan {tuple(plan)}: device "
              f"{dev_ms(lambda: chamfer.nn_half_tiled_pair(x, y)):.4f} ms; one group "
              f"{tuple(one)} {dev_ms(lambda: chamfer.nn_half_tiled_pair(x, y, one)):.4f}, bit for "
              f"bit {same} ({card})", flush=True)


if __name__ == "__main__":
    main()
