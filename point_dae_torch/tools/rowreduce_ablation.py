"""Ablations of the two row reductions on one NVIDIA GPU: the EdgeConv
aggregate (``csrc/edgeconv.cu``) and the row scatter-add (``csrc/scatter.cu``).

Builds (nvcc, sm_90a, into ``build/rowreduce_ablation/``):

- ``tools/aggregate_parent.cu`` and ``tools/scatter_parent.cu``, the previous
  designs (the aggregate a warp a row over rows read from L2; the scatter's
  counting sort one block a cloud), kept unchanged as the yardsticks;
- variants of ``csrc/scatter.cu`` whose sums keep another number of loads
  in flight a lane (``batch4``, ``batch16``) or run in blocks of nine
  warps (``warps9``), whose place pass runs in blocks of eight warps
  (``place_warps8``) or lacks one part
  (``place_no_walk``, ``place_no_store``, ``place_no_hist``: their lists are
  wrong by design, only their time is read), and of ``csrc/edgeconv.cu``
  whose aggregate reads a row's indices one round at a time
  (``idx_scalar``).

At the aggregate's path shapes (the DGCNN step's four, fine-tune C's (32,
2048), (4, 4096)) it holds the current kernel bit for bit against the
previous design and prints both device times (torch.profiler), the current
one under its plan and under its neighbours (slices twice and half as wide,
1 to 8 row chunks, 8, 16 or 32 warps a block); at the scatter's
(PT and DGCNN part segmentation, f32, and DGCNN in bf16, on real indices) it
holds the outputs bit for bit and prints the device time by launch of the
previous design (sort, sums), of the current one (count, place, sums)
under its plan, with half and twice its segments and (below 32) twice the
lanes a row, and of each variant. Every time beside the card's name and
power limit.

    python3 -m point_dae_torch.tools.rowreduce_ablation
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

K = 20
# (B, N, C): the DGCNN step's four EdgeConv widths, fine-tune C, (4, 4096)
AGG_SHAPES = ((128, 1024, 64), (128, 1024, 64), (128, 1024, 128), (128, 1024, 256),
              (32, 2048, 64), (4, 4096, 64))
_BATCH = "constexpr int kBatch = 8;"
_SUMWARPS = "constexpr int kSumWarps = 8;"
_WALK = "    for (int base = w0; base < w1; base += 32) {"
_HIST = "    for (int q = w0 + lane; q < w1; q += 32) {"
_STORE = "      if (ok) ob[pos] = q;"
_IDX4 = "  const int idx4 = k % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;"
# name: (source, the change, replacements)
VARIANTS = {
    "aggregate_parent": ("tools/aggregate_parent.cu", "the previous design", []),
    "scatter_parent": ("tools/scatter_parent.cu", "the previous design", []),
    "batch4": ("csrc/scatter.cu", "sums with four loads in flight a lane",
               [(_BATCH, _BATCH.replace("8;", "4;"))]),
    "batch16": ("csrc/scatter.cu", "sums with sixteen loads in flight a lane",
                [(_BATCH, _BATCH.replace("8;", "16;"))]),
    "warps9": ("csrc/scatter.cu", "sums in blocks of nine warps (at C 1152, a row's nine "
               "slices in one block)", [(_SUMWARPS, _SUMWARPS.replace("8;", "9;"))]),
    "place_warps8": ("csrc/scatter.cu", "the place pass in blocks of eight warps, each "
                     "walking twice as many entries",
                     [("constexpr int kPlaceWarps = 16;", "constexpr int kPlaceWarps = 8;")]),
    "place_no_walk": ("csrc/scatter.cu", "the place pass without its walk (what remains is "
                      "the staging, the warps' histograms and offsets)",
                      [(_WALK, _WALK.replace("base < w1;", "base < w0;"))]),
    "place_no_store": ("csrc/scatter.cu", "the place pass ranks every entry but stores none",
                       [(_STORE, _STORE.replace("if (ok)", "if (ok && pos < 0)"))]),
    "place_no_hist": ("csrc/scatter.cu", "the place pass without the warps' histograms",
                      [(_HIST, _HIST.replace("q < w1;", "q < w0;"))]),
    "idx_scalar": ("csrc/edgeconv.cu", "the staged aggregate reads a row's indices one "
                   "round at a time (no 16-byte loads of four)",
                   [(_IDX4, "  const int idx4 = 0;")]),
}
P, I = ctypes.c_void_p, ctypes.c_int
SCATTER_SPLIT = (("count", "scatter_count"), ("place", "scatter_place"),
                 ("sums", "scatter_sum"),
                 ("sort", "sort_rows"), ("sums", "sum_rows"))


def build(names) -> dict:
    """Compile the named variants, one nvcc each, all at once: {name:
    (ctypes library, nvcc's -Xptxas -v output)}."""
    from point_dae_torch.utils import kernels

    pkg = os.path.dirname(kernels.CSRC)
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "rowreduce_ablation")
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
        raise RuntimeError(f"a previous design failed to launch ({err})")


def parent_aggregate(lib, U, idx, track):
    """(M, m, S1, S2, rM, rm) of the previous aggregate design (rM / rm
    None without ``track``)."""
    import torch

    B, N, C = U.shape
    k = idx.shape[-1]
    fn = lib.edgeconv_aggregate
    fn.argtypes = [P, P] + [I] * 5 + [P] * 7
    fn.restype = I
    M, m, S1, S2 = (torch.empty_like(U) for _ in range(4))
    rM, rm = ((torch.empty(U.shape, dtype=torch.uint8, device=U.device) for _ in range(2))
              if track else (None, None))
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    _checked(fn(U.data_ptr(), idx.data_ptr(), B, N, C, k, int(track), M.data_ptr(),
                m.data_ptr(), S1.data_ptr(), S2.data_ptr(), ptr(rM), ptr(rm),
                torch.cuda.current_stream().cuda_stream))
    return M, m, S1, S2, rM, rm


def parent_scatter(lib, idx, g, N):
    """out (B, N, C) f32 of the previous scatter design (idx int32)."""
    import torch

    B, Q, C = g.shape
    fn = lib.scatter_rows_add
    fn.argtypes = [P, I, P] + [I] * 5 + [P] * 4
    fn.restype = I
    vec = next((v for v in (4, 2) if C % v == 0 and 32 * v <= C), 1)   # its _vec_width
    row_ptr = torch.empty((B, N + 1), dtype=torch.int32, device=g.device)
    order = torch.empty((B, Q), dtype=torch.int32, device=g.device)
    out = torch.empty((B, N, C), dtype=torch.float32, device=g.device)
    _checked(fn(g.data_ptr(), int(g.dtype == torch.bfloat16), idx.data_ptr(), B, Q, N, C, vec,
                row_ptr.data_ptr(), order.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream))
    return out


def by_launch(fn, groups, calls=5, windows=3):
    """Device milliseconds a call by kernel-name group (torch.profiler).
    Each window first launches 32 short sleep kernels, left out of the
    counts: a window loses its first few kernel records. A window whose
    groups hold no device time is taken again, up to ``windows`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                torch.cuda._sleep(600_000)
            torch.cuda.synchronize()
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
        if sum(out.values()) > 0:
            return out
    raise RuntimeError(f"no device time recorded for {sorted(groups)} in {windows} windows")


def scatter_inputs(torch, device, seed=40):
    """The part-segmentation paths' indices on one random (16, 2048, 3)
    batch: PT's interpolation (three_nn to the 128 FPS centres) and DGCNN's
    edge gather (kNN, k 20): [(name, idx, N, C, dtype)]."""
    from point_dae_torch.ops.geometry import fps_knn, knn, three_nn

    g = torch.Generator(device=device).manual_seed(seed)
    pts = torch.randn((16, 2048, 3), generator=g, device=device)
    _, center, _ = fps_knn(pts, 128, 32)
    idx_pt = three_nn(pts, center)[1].reshape(16, -1).int().contiguous()
    idx_dg = knn(pts, pts, K)[1].reshape(16, -1).int().contiguous()
    return [("PT", idx_pt, 128, 1152, torch.float32),
            ("DGCNN", idx_dg, 2048, 64, torch.float32),
            ("DGCNN bf16", idx_dg, 2048, 64, torch.bfloat16)]


def main() -> None:
    import torch

    from point_dae_torch.ops import edgeconv, gather
    from point_dae_torch.tools.fps_ablation import cuda_ms, with_library
    from point_dae_torch.utils import kernels

    if not torch.cuda.is_available():
        raise SystemExit("rowreduce_ablation needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    names = [n for n in VARIANTS if len(sys.argv) < 2 or n.startswith(tuple(sys.argv[1:]))]
    from point_dae_torch.tools.edgeconv_ablation import build_in_background

    join = build_in_background(names, build)
    logs = kernels.build(["edgeconv", "scatter"])
    libs = join()
    for name, log in logs.items():   # the kernels' registers and spills (ptxas)
        for fn, regs in re.findall(r"Compiling entry function '(\w*(?:aggregate|scatter)\w*)'"
                                   r"[\s\S]*?Used (\d+) registers", log):
            print(f"{name}: {fn[:60]} {regs} registers", flush=True)
    for name, (_, log) in libs.items():
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)), key=int)
        print(f"{name}: registers {regs} ({VARIANTS[name][1]})", flush=True)
    dev = torch.device("cuda")
    sms = kernels.card_sms(dev)
    agg_groups = {"aggregate": r"edgeconv_aggregate"}

    g = torch.Generator(device=dev).manual_seed(0)
    tot = {"current": 0.0, "parent": 0.0}
    for B, N, C in AGG_SHAPES:
        U = torch.randn((B, N, C), generator=g, device=dev).bfloat16().float()
        U[:, N - 64:] = U[:, :64]                              # value ties
        xf = torch.randn((B, N, 3), generator=g, device=dev)
        idx = edgeconv.knn_select_plain(xf, K) if N <= 1024 else gather_knn(torch, xf)
        plan = edgeconv.aggregate_plan(B, N, C, sms)
        line = [f"aggregate ({B}, {N}, C {C}, k {K}) plan {tuple(plan)}:"]
        for track in (True, False):
            got = edgeconv.aggregate_fwd_kernel(U, idx, track)
            prev = parent_aggregate(libs["aggregate_parent"][0], U, idx, track)
            same = all(a is None or torch.equal(a, b) for a, b in zip(got, prev))
            cur = by_launch(lambda: edgeconv.aggregate_fwd_kernel(U, idx, track),
                            agg_groups, 10)["aggregate"]
            par = by_launch(lambda: parent_aggregate(libs["aggregate_parent"][0], U, idx,
                                                     track), agg_groups, 10)["aggregate"]
            if track and N <= 1024:
                tot["current"] += cur
                tot["parent"] += par
            line.append(f"  track {track}: current {cur:.4f}, previous design {par:.4f}, "
                        f"bit for bit {same}")
        others = []
        for lanes in {plan.lanes, plan.lanes * 2, max(1, plan.lanes // 2)} & set(
                edgeconv.AGG_LANES):
            for chunks in (1, 2, 4, 8):
                for warps in edgeconv.AGG_WARPS:
                    p = edgeconv.AggPlan(lanes, chunks, warps)
                    if (p == plan or p.smem(N) > edgeconv.BLOCK_SMEM or chunks > N
                            or (lanes * 4 >= C + 4 and lanes > 1)):
                        continue
                    others.append((p, by_launch(lambda: edgeconv.aggregate_fwd_kernel(
                        U, idx, True, use_plan=p), agg_groups, 5)["aggregate"]))
        others.append((edgeconv.AggPlan(0, 1), by_launch(lambda: edgeconv.aggregate_fwd_kernel(
            U, idx, True, use_plan=edgeconv.AggPlan(0, 1)), agg_groups, 5)["aggregate"]))
        line.append("  other plans (track on): " + ", ".join(
            f"{tuple(p)} {ms:.4f}" for p, ms in sorted(others, key=lambda x: x[1])))
        if "idx_scalar" in libs:
            ms = with_library("edgeconv", libs["idx_scalar"][0], lambda: by_launch(
                lambda: edgeconv.aggregate_fwd_kernel(U, idx, True), agg_groups, 10))
            line.append(f"  idx_scalar (track on): {ms['aggregate']:.4f}")
        print("\n".join(line), flush=True)
        del U, xf, idx
        torch.cuda.empty_cache()
    print(f"aggregate, the DGCNN step's four shapes with track: current {tot['current']:.4f}, "
          f"previous design {tot['parent']:.4f} device ms ({card})", flush=True)

    for name, idx, N, C, dtype in scatter_inputs(torch, dev):
        B, Q = idx.shape
        gt = torch.randn((B, Q, C), generator=g, device=dev).to(dtype)
        want = gather.scatter_rows_add_plain(idx.cpu(), gt.cpu(), N)
        got = gather.scatter_rows_add(idx, gt, N)
        prev = parent_scatter(libs["scatter_parent"][0], idx, gt, N)
        plan = gather.scatter_plan(B, Q, C, gt.element_size(), 256, sms)
        ok = torch.equal(got.cpu(), want) and torch.equal(prev, got)
        line = [f"scatter {name} (B {B}, Q {Q}, N {N}, C {C}) plan {tuple(plan)}: bit for bit "
                f"with the plain version and the previous design {ok}"]

        def split_of(fn):
            out = {}
            for k, v in by_launch(fn, {f"{lb}:{key}": key for lb, key in SCATTER_SPLIT},
                                  10).items():
                if v:
                    out[k.split(":")[0]] = out.get(k.split(":")[0], 0.0) + v
            return out

        def fmt(split):
            return ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + \
                f" (total {sum(split.values()):.4f})"

        line.append("  previous design: " + fmt(split_of(
            lambda: parent_scatter(libs["scatter_parent"][0], idx, gt, N))))
        line.append("  current: " + fmt(split_of(lambda: gather.scatter_rows_add(idx, gt, N)))
                    + f"; {cuda_ms(lambda: gather.scatter_rows_add(idx, gt, N), 20):.4f} ms a "
                    f"call (CUDA events)")
        alts = [plan._replace(segs=segs) for segs in
                sorted({max(1, plan.segs // 2), min(gather.MAX_SEGS, plan.segs * 2)})]
        if plan.lanes < 32:
            alts += [plan._replace(lanes=plan.lanes * 2)]
        for p in alts:
            same = torch.equal(gather.scatter_rows_add(idx, gt, N, use_plan=p), got)
            line.append(f"  {tuple(p)}: " + fmt(split_of(
                lambda: gather.scatter_rows_add(idx, gt, N, use_plan=p)))
                + f", bit for bit {same}")
        for vname in ("batch4", "batch16", "warps9", "place_warps8"):
            if vname in libs:
                same = with_library("scatter", libs[vname][0], lambda: torch.equal(
                    gather.scatter_rows_add(idx, gt, N), got))
                split = with_library("scatter", libs[vname][0], lambda: split_of(
                    lambda: gather.scatter_rows_add(idx, gt, N)))
                ev = with_library("scatter", libs[vname][0], lambda: cuda_ms(
                    lambda: gather.scatter_rows_add(idx, gt, N), 20))
                line.append(f"  {vname}: {fmt(split)}; {ev:.4f} ms a call (CUDA events), "
                            f"bit for bit {same}")
        for vname in ("place_no_walk", "place_no_store", "place_no_hist"):   # the sort alone
            if vname in libs:
                split = with_library("scatter", libs[vname][0], lambda: split_of(
                    lambda: gather.scatter_lists_kernel(idx, N, plan.segs)))
                line.append(f"  {vname}, the sort alone: {fmt(split)}")
        print("\n".join(line), flush=True)
        del gt, want, got, prev
        torch.cuda.empty_cache()


def gather_knn(torch, xf):
    """The kNN rows of a cloud past 1024 points (the card's kernel)."""
    from point_dae_torch.ops import tiled_knn

    return tiled_knn.knn_kernel(xf, xf, K)[1]


if __name__ == "__main__":
    main()
