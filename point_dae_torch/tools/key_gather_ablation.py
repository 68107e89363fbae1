"""Ablations of the key gather (``csrc/gather.cu:gather_by_key_small_c``) on
one NVIDIA GPU.

Builds (nvcc, sm_90a, into ``build/key_gather_ablation/``):

- ``tools/key_gather_parent.cu``, the previous design (a block a cloud's 256
  draws, each block rebuilding the cloud's table from int32 keys, one
  output element a thread), kept unchanged as the yardstick;
- ``empty``: a kernel that does nothing, launched on the current design's
  grid (the floor of a launch's device time), and a copy of as many bytes
  as the output on that grid (a read and a write of each 16 bytes);
- variants of ``csrc/gather.cu``: 3-wide rows read in three 4-byte loads
  and staged in shared memory for 16-byte stores, as other widths are,
  instead of an 8-byte and a 4-byte load and store a row
  (``staged_rows``); the rows not read (``no_copy``: the output holds the
  selected points' indices, wrong by design, only its time is read).

At the two dropout shapes ((128, 2048, 3) and (128, 1024, 3) -> 1024, the
masks of ``chip_smoke.py``'s key-gather phase) it holds the current kernel
bit for bit against the previous design and the plain twins and prints
the device time (torch.profiler) of the previous design (its kernel, and
with the casts of int64 keys and draws to int32), of the current one from
int64 keys and from the mask and f32 uniforms in blocks of 1024 threads,
of 256 and 512, and in each variant; a call of the masked resample on
CUDA events (the previous chain from the mask, the current
``resample_batch``) and its wrapper's host time; and the empty kernel.
Every time beside the card's name and power limit.

    python3 -m point_dae_torch.tools.key_gather_ablation
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

_ROW3 = "    if (C == 3) {   // a 3-wide row in two loads and two stores, each aligned; no staging"
_LOAD3 = "float3 v = load_row3(xb + max(n, 0) * 3);"
_EMPTY = """#include "common.cuh"
__global__ void empty_kernel() {}
__global__ void copy_kernel(const float4* in, float4* out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = in[i];
}
PDAE_EXPORT int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
PDAE_EXPORT int copy_launch(const void* in, void* out, int n, int blocks, int threads,
                            void* stream) {
  copy_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(in), static_cast<float4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
"""
# name: (source, the change, replacements); source None: the text in the list
VARIANTS = {
    "key_gather_parent": ("tools/key_gather_parent.cu", "the previous design", []),
    "empty": (None, "an empty kernel and a copy of the output's size on the current grid",
              [_EMPTY]),
    "staged_rows": ("csrc/gather.cu", "3-wide rows read in three 4-byte loads and staged "
                    "for 16-byte stores, as other widths are", [(_ROW3, "    if (false) {")]),
    "no_copy": ("csrc/gather.cu", "no row read: the point's index stored (wrong by design)",
                [(_LOAD3, "float3 v = make_float3(n, n, n);")]),
}
P, I = ctypes.c_void_p, ctypes.c_int
GROUPS = {"kernel": r"gather_by_key_kernel", "empty": r"empty_kernel", "copy": r"copy_kernel"}
ALL = r"^(?!.*spin_kernel)"   # every kernel but the profiler window's primer
THREADS = (256, 512, 1024)


def build(names) -> dict:
    """Compile the named variants, one nvcc each, all at once: {name:
    (ctypes library, nvcc's -Xptxas -v output)}."""
    from point_dae_torch.utils import kernels

    pkg = os.path.dirname(kernels.CSRC)
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "key_gather_ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    try:
        for name in names:
            src, _, reps = VARIANTS[name]
            if src is None:
                text = reps[0]
            else:
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


def parent_gather(lib, x, keys, draw):
    """The previous wrapper: keys and draws cast to int32, then its kernel."""
    import torch

    keys32 = keys.to(torch.int32).contiguous()
    draw32 = draw.to(torch.int32).contiguous()
    B, N, C = x.shape
    Q = draw32.shape[1]
    fn = lib.gather_by_key_small_c
    fn.argtypes = [P, P, P, P, I, I, I, I, P]
    fn.restype = I
    out = torch.empty((B, Q, C), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), keys32.data_ptr(), draw32.data_ptr(), out.data_ptr(), B, N, Q, C,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the previous key gather failed to launch ({err})")
    return out


def parent_resample(lib, x, mask, u):
    """The previous kernel branch of ``resample_batch``: the ranks from the
    uniforms, the keys from the mask, the casts and the kernel."""
    import torch

    cnt = mask.sum(1).clamp_min(1)[:, None]
    draws = (u * cnt).long().clamp_max(cnt - 1)
    rank = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    keys = torch.where(mask, rank, -1)
    return parent_gather(lib, x, keys, draws)


def inputs(torch, device, seed=0):
    """The masks of ``chip_smoke.py``'s key-gather phase: the patches of a
    64-patch mask (about half kept) of 128 clouds of 2048 points, cloud 5
    with none; dropout_global_p3's 716 of 1024 kept. With f32 uniforms."""
    g = torch.Generator(device=device).manual_seed(seed)
    B = 128
    flat = torch.randn((B, 2048, 3), generator=g, device=device)
    keep = torch.rand((64,), generator=g, device=device) > 0.5
    keep[0] = True
    mask_p = keep[None, :, None].expand(B, 64, 32).reshape(B, 2048).clone()
    mask_p[5] = False
    pts = torch.randn((B, 1024, 3), generator=g, device=device)
    order = torch.argsort(torch.rand((B, 1024), generator=g, device=device), dim=-1)
    mask_g = torch.empty_like(order).scatter_(
        1, order, torch.arange(1024, device=device).expand(B, -1)) < int(1024 * (1.0 - 0.3))
    u = torch.rand((B, 1024), generator=g, device=device)
    return (("patch", flat, mask_p, u), ("global_p3", pts, mask_g, u))


def host_us(fn, calls=200) -> float:
    """Host microseconds a call of fn, enqueue only (no synchronise inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> None:
    import torch

    from point_dae_torch.ops import gather
    from point_dae_torch.ops.geometry import resample_batch
    from point_dae_torch.tools.edgeconv_ablation import build_in_background
    from point_dae_torch.tools.fps_ablation import cuda_ms, with_library
    from point_dae_torch.tools.rowreduce_ablation import by_launch
    from point_dae_torch.utils import kernels

    if not torch.cuda.is_available():
        raise SystemExit("key_gather_ablation needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    names = [n for n in VARIANTS if len(sys.argv) < 2 or n.startswith(tuple(sys.argv[1:]))]
    join = build_in_background(names, build)
    logs = kernels.build(["gather"])
    libs = join()
    for name, log in list(logs.items()) + [(n, lg) for n, (_, lg) in libs.items()]:
        for line in log.splitlines():
            if "registers" in line:
                print(f"{name}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    parent = libs["key_gather_parent"][0] if "key_gather_parent" in libs else None

    def dev_ms(fn, group="kernel", calls=20):
        return by_launch(fn, {group: GROUPS[group]}, calls)[group]

    for name, x, mask, u in inputs(torch, dev):
        B, N, C = x.shape
        Q = u.shape[1]
        ranks = gather.ranks_from_uniforms(mask, u)
        keys = torch.where(mask, torch.cumsum(mask.int(), 1) - 1, -1)
        want = gather.gather_by_key_plain(x, keys, ranks)
        threads = gather.key_gather_threads(Q)
        form_a = lambda: gather.gather_by_key(x, keys, ranks)  # noqa: E731
        form_b = lambda: gather.gather_by_mask(x, mask, u)  # noqa: E731
        resample = lambda: resample_batch(x, mask, Q, draws=u)  # noqa: E731
        same = all(torch.equal(f(), want) for f in (form_a, form_b, resample))
        lines = [f"{name} ({B}, {N}, {C}) -> {Q}, blocks of {threads}: both forms and "
                 f"resample_batch bit for bit with the plain version {same}"]
        if parent is not None:
            prev = lambda: parent_gather(parent, x, keys, ranks)  # noqa: E731
            prev_r = lambda: parent_resample(parent, x, mask, u)  # noqa: E731
            ok = torch.equal(prev(), want) and torch.equal(prev_r(), want)
            split = by_launch(prev, {"kernel": GROUPS["kernel"], "casts": r"copy|cast|elementwise"},
                              20)
            chain = by_launch(prev_r, {"all": ALL}, 20)["all"]
            lines.append(f"  previous design: kernel {split['kernel']:.4f} ms, with the casts "
                         f"{split['kernel'] + split['casts']:.4f}; {cuda_ms(prev, 50):.4f} a "
                         f"call; its resample chain from the mask: device {chain:.4f} ms, "
                         f"{cuda_ms(prev_r, 50):.4f} a call, host {host_us(prev_r):.1f} us; "
                         f"bit for bit {ok}")
        lines.append(f"  current: from int64 keys {dev_ms(form_a):.4f} ms, "
                     f"{cuda_ms(form_a, 50):.4f} a call; from the mask and f32 uniforms "
                     f"{dev_ms(form_b):.4f} ms, {cuda_ms(form_b, 50):.4f} a call; "
                     f"resample_batch {cuda_ms(resample, 50):.4f} a call, host "
                     f"{host_us(resample):.1f} us (the wrapper alone "
                     f"{host_us(form_b):.1f})")
        timed = []
        for p in THREADS:
            if p == threads:
                continue
            fn = lambda: gather.gather_by_mask(x, mask, u, threads=p)  # noqa: E731
            timed.append((dev_ms(fn), p, torch.equal(fn(), want)))
        lines.append("  blocks of other widths (mask): " + ", ".join(
            f"{p} {ms:.4f}{'' if ok else ' DIFFERS'}" for ms, p, ok in sorted(timed)))
        for vname in ("staged_rows", "no_copy"):
            if vname in libs:
                lib = libs[vname][0]
                ok = with_library("gather", lib, lambda: torch.equal(form_b(), want))
                ms = with_library("gather", lib, lambda: dev_ms(form_b))
                lines.append(f"  {vname} ({VARIANTS[vname][1]}): device {ms:.4f} ms, bit "
                             f"for bit {ok}")
        if "empty" in libs:
            fn = libs["empty"][0].empty_launch
            fn.argtypes = [I, I, P]
            fn.restype = I
            stream = torch.cuda.current_stream().cuda_stream
            cp = libs["empty"][0].copy_launch
            cp.argtypes = [P, P, I, I, I, P]
            cp.restype = I
            src = torch.empty(B * Q * C, device=dev)
            dst = torch.empty_like(src)
            n4 = src.numel() // 4
            copy = lambda: cp(src.data_ptr(), dst.data_ptr(), n4, B, threads,  # noqa: E731
                              stream)
            lines.append(f"  empty kernel on {B} blocks of {threads}: device "
                         f"{dev_ms(lambda: fn(B, threads, stream), 'empty'):.4f} ms; "
                         f"on one block of 32 "
                         f"{dev_ms(lambda: fn(1, 32, stream), 'empty'):.4f}; a copy of the "
                         f"output's {4 * src.numel()} bytes on that grid "
                         f"{dev_ms(copy, 'copy'):.4f}")
        print("\n".join(lines) + f" ({card})", flush=True)


if __name__ == "__main__":
    main()
