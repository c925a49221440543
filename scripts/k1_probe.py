#!/usr/bin/env python3
"""What bounds K1 (grad_traj_optimization_torch/csrc/minplus.cu) on a GPU.

Builds variants of the kernel source, each by a textual edit of the file
as it stands, and times one bench-shaped min-plus pass with each:

  as is          the kernel;
  copies only    the min-plus loop removed (loads, staging, stores);
  loop, FMNMX    the global loads replaced by a synthetic tile;
  loop, IMNMX    the same, the min taken on the float bit patterns;
  loop, FADD     the same, an FADD in the min's place.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/k1_probe.py

It prints the card and its power limit, ptxas's registers for each
variant, and the device time of the y pass (1024 x 100 x 100 x 25 as
(102400, 100, 25)) and the x pass ((1024, 100, 2500)), min of 5 warm runs.
"""

import concurrent.futures
import ctypes
import math
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "grad_traj_optimization_torch", "csrc", "minplus.cu")
MIN = "best[r] = fminf(best[r], fmaf(d, d, fv[u]));"
LOADS = ("src[base[c] + v]", "src[base[c] + v * I]")
SYNTH = "static_cast<float>((v * 7 + c) & 1023)"
LOOP = "    int v = 0;\n    for (; v + kU <= n; v += kU) {"


def variants(src):
    def edit(text, pairs):
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"minplus.cu no longer holds {old!r}")
            text = text.replace(old, new)
        return text

    no_loads = [(LOADS[1], SYNTH), (LOADS[0], SYNTH)]
    return {
        "as is": src,
        "copies only": edit(src, [(LOOP, "    int v = n;\n"
                                   "    for (r0 = 0; r0 < kR; ++r0)\n"
                                   "      best[r0] = fl[min(g * kR + r0, n - 1)];"
                                   "\n    for (; v + kU <= n; v += kU) {"),
                                  ("  float best[kR];", "  float best[kR];\n"
                                   "  int r0;")]),
        "loop, FMNMX": edit(src, no_loads),
        "loop, IMNMX": edit(src, no_loads + [(MIN, "best[r] = __int_as_float("
                                              "min(__float_as_int(best[r]), "
                                              "__float_as_int(fmaf(d, d, "
                                              "fv[u]))));")]),
        "loop, FADD": edit(src, no_loads + [(MIN, "best[r] = best[r] + "
                                             "fmaf(d, d, fv[u]);")]),
    }


def build(idx, name, text, out_dir):
    cu = os.path.join(out_dir, f"variant{idx}.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as fh:
        fh.write(text)
    proc = subprocess.run(
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so,
         cu], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    regs = [ln.strip() for ln in proc.stderr.splitlines() if "Used" in ln]
    return name, so, regs


def device_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def main():
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    with open(SRC) as fh:
        src = fh.read()
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor() as pool:
            built = list(pool.map(lambda iv: build(iv[0], *iv[1], tmp),
                                  enumerate(variants(src).items())))
        dev = torch.device("cuda:0")
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randint(0, 60, (1024, 100, 100, 25), device=dev,
                          generator=gen).float() ** 2
        x[torch.rand(x.shape, device=dev, generator=gen) < 0.4] = 1e12
        out = torch.empty_like(x)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for name, so, regs in built:
            fn = ctypes.CDLL(so).gto_minplus_axis
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
            times = []
            for O, n, I in ((102400, 100, 25), (1024, 100, 2500)):
                times.append(device_ms(lambda: fn(
                    x.data_ptr(), out.data_ptr(), O, n, I, stream)))
            print(f"{name:12s} y pass {times[0]:.3f} ms, x pass "
                  f"{times[1]:.3f} ms; {'; '.join(regs)} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
