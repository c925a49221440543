#!/usr/bin/env python3
"""Where the time of K1's long-line kernel goes (gto_minplus_long in
grad_traj_optimization_torch/csrc/minplus.cu) on a GPU.

Builds the kernel source twice with the package's own nvcc flags: as it
stands, and with -DGTO_LONG_PROBE, which makes thread 0 of every block add
each phase's clock64() cycles to counters after the kernel's own four.  It
then runs the x pass of an 8192 x 512 x 48 grid out of place with each: the
grid's z and y passes of an occupancy draw (default_rng(0), occupancy 5e-4,
as chip_smoke.py's phase 20) and random reals in [0, 1e4).

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/k1_long_probe.py [nx ny nz]

It prints the card and its power limit, ptxas's registers, the device
time of each pass (min of 3 warm runs, CUDA events; the instrumented
build's too), and the cycles a line spends in each phase: staging the
line, the band envelopes, the merge levels, the merged list, the outputs.
"""

import concurrent.futures
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from grad_traj_optimization_torch import _build  # noqa: E402

SOURCES = [os.path.join(_build.CSRC_DIR, name)
           for name in ("minplus.cu", "errors.cu")]
ENTRIES = ("gto_minplus_long", "gto_minplus_long_scratch")
PHASES = ("stage", "band envelopes", "merge levels", "merged list",
          "outputs")


def build(defines, out_dir):
    so = os.path.join(out_dir, f"minplus{len(defines)}.so")
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-o", so,
         *SOURCES], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    lines = proc.stderr.splitlines()
    regs = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "minplus_long" in ln:
            regs += [x.strip() for x in lines[i:i + 4] if "Used" in x]
    return _build.open_library(so, ENTRIES), regs


def device_ms(fn, reps=3):
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


def inputs(shape, dev):
    from grad_traj_optimization_torch.fields import sdf
    from grad_traj_optimization_torch.ops import edt_cuda

    rng = np.random.default_rng(0)
    occ = np.empty(shape, np.float32)
    for part in np.array_split(occ, 8):
        part[:] = rng.random(part.shape) < 5e-4
    fed = sdf._nearest_sq_1d(torch.as_tensor(occ, device=dev), dim=-1)
    edt_cuda.minplus_along(fed, dim=-2)
    gen = torch.Generator(device=dev).manual_seed(0)
    return {"occupancy grid's z and y passes": fed,
            "random reals": torch.rand(shape, device=dev, generator=gen)
            * 1e4}


def main(argv):
    if not torch.cuda.is_available():
        print("k1_long_probe: no CUDA device visible", file=sys.stderr)
        return 2
    shape = tuple(int(a) for a in argv[:3]) if len(argv) >= 3 else \
        (8192, 512, 48)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor() as pool:
            (plain_lib, regs), (inst_lib, inst_regs) = pool.map(
                lambda d: build(d, tmp), ([], ["-DGTO_LONG_PROBE"]))
        print(f"as is: {'; '.join(regs)}; instrumented: "
              f"{'; '.join(inst_regs)}")
        O, n, I = 1, shape[0], shape[1] * shape[2]
        counts = torch.zeros(16, dtype=torch.int64, device=dev)
        for tag, x in inputs(shape, dev).items():
            out = torch.empty_like(x)
            scratch = torch.empty(
                max(1, plain_lib.gto_minplus_long_scratch(n, O * I)),
                dtype=torch.uint8, device=dev)

            def run(lib):
                rc = lib.gto_minplus_long(
                    _build.ptr(x), _build.ptr(out), _build.ptr(scratch),
                    _build.ptr(counts), O, n, I, _build.stream(x))
                _build.check(lib, rc, "gto_minplus_long")

            ms = device_ms(lambda: run(plain_lib))
            ms_inst = device_ms(lambda: run(inst_lib))
            counts.zero_()
            run(inst_lib)
            c = counts.tolist()
            lines = c[0] + c[2]
            per_line = {p: c[4 + i] / max(c[0], 1)
                        for i, p in enumerate(PHASES)}
            if c[0] == 0:  # two-rounding lines stop after the staging
                per_line = {"stage + two-rounding outputs": None}
            print(f"{shape} x pass, {tag}: {ms:.3f} ms (instrumented "
                  f"{ms_inst:.3f}); lines {lines}: integer {c[0]} "
                  f"({c[1]} outputs), two-rounding {c[2]} ({c[3]} "
                  f"outputs); cycles a line on the integer path: "
                  + ", ".join(f"{p} {v:.0f}" for p, v in per_line.items()
                              if v is not None)
                  + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
