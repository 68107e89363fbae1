"""Where the host clock of a step goes across a long process, on one NVIDIA
GPU: ``chip_smoke.py``'s backbone phase (3DETR, ``Point_MAE``,
``MaskFeat_transformer``) first, right after the kernels' build, then the
whole of ``chip_smoke.py`` in the same process (its backbone phase again
near its end), with a probe of the host after every phase:

- the host time of a tiny launch (3000 ``add_`` on a one-element tensor
  after 200 warm-ups; the process's CPU time beside it);
- a pure-Python loop (``sum(range(2_000_000))``): the host CPU's own speed;
- the process's CPU time during a 0.5 s sleep (other threads of the process
  at work), its threads and child processes, the load average;
- whether the autograd profiler is on, the number of Python objects, the
  collector's counts and the card's reserved memory.

Every line starts ``HOSTPROBE <phase>``; the steps' lines are
``chip_smoke.py``'s own. Run from the repository root (the output is long):

    python3 -m point_dae_torch.tools.host_drift > chiprun_out/host_drift.log
"""
import gc
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_probe(torch, log):
    x = torch.zeros(1, device="cuda")

    def probe(tag: str) -> None:
        torch.cuda.synchronize()
        for _ in range(200):
            x.add_(1.0)
        torch.cuda.synchronize()
        t, c = time.perf_counter(), time.process_time()
        for _ in range(3000):
            x.add_(1.0)
        host, hcpu = time.perf_counter() - t, time.process_time() - c
        torch.cuda.synchronize()
        t = time.perf_counter()
        sum(range(2_000_000))
        py = time.perf_counter() - t
        c = time.process_time()
        time.sleep(0.5)
        idle_cpu = time.process_time() - c
        pid, kids = os.getpid(), 0
        for d in os.listdir("/proc"):
            if d.isdigit():
                try:
                    with open(f"/proc/{d}/stat") as f:
                        kids += int(f.read().rsplit(")", 1)[1].split()[1]) == pid
                except OSError:
                    pass
        with open("/proc/self/status") as f:
            threads = [line.split()[1] for line in f if line.startswith("Threads")][0]
        prof = getattr(torch.autograd.profiler, "_is_profiler_enabled", "?")
        log(f"  HOSTPROBE {tag}: launch {host / 3000 * 1e6:.2f} us (cpu "
            f"{hcpu / 3000 * 1e6:.2f}), py loop {py * 1e3:.1f} ms, process cpu in 0.5 s "
            f"sleep {idle_cpu * 1e3:.1f} ms, threads {threads}, children {kids}, load "
            f"{os.getloadavg()}, profiler {prof}, objects {len(gc.get_objects())}, gc "
            f"{gc.get_count()}, reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB")

    return probe


def main() -> None:
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch

    import chip_smoke as cs
    from point_dae_torch.utils import kernels

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    probe = make_probe(torch, cs.log)
    stamp = cs.stamp

    def stamp_and_probe(what: str) -> None:
        stamp(what)
        probe(what)

    cs.stamp = stamp_and_probe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    cs.log(card)
    kernels.build()
    probe("start")
    cs.log("EARLY backbones:")
    cs.phase_backbones(torch, torch.device("cuda"), card)
    probe("early backbones")
    torch.cuda.empty_cache()
    cs.log("WHOLE SCRIPT:")
    cs.main()


if __name__ == "__main__":
    main()
