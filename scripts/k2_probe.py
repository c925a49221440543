#!/usr/bin/env python3
"""What K2, the trilinear lookup (grad_traj_optimization_torch/csrc/
trilinear.cuh), costs on a GPU: inside K3 and as its own launch.

Builds the kernel library from variants of csrc/, each by a textual edit
of trilinear.cuh as it stands and by nvcc into a temporary directory:

  as is                 the lookup;
  synthetic corners     the eight corner loads replaced by a value computed
                        from the corner's address (isolates the loads);
  multiply, not divide  each division by res a multiply by 1/res
                        (isolates the divisions; not bitwise);
  IEEE division         each division by res __fdiv_rn, the lookup frame
                        and its range check kept (what the division
                        sequence saves; only for a header with
                        gto_div_fast);
  no range check        the fast division without the lookup's one range
                        check and its rerun (what the check costs; only for
                        a header with gto_div_fast);
  branch at each division
                        each division checks its own dividend and branches
                        to __fdiv_rn (gto_div), in place of the one check a
                        lookup (only for a header with gto_div_fast);
  no lookup             the lookup returns d = 1 and a zero gradient (its
                        whole share of K3).

With --baseline DIR (another csrc/, e.g. a parent commit's, unpacked with
git archive) the same variants are built from DIR's header too, named
"baseline <variant>", and the K3 and K2 outputs of "baseline as is" are
compared with "as is" bit for bit.

Each variant is timed at the bench shape (1024 random maps of 100 x 100 x
25 at 0.2 m, 7 waypoints; chip_smoke.py phases 4 and 5):

  K3    OptimizerConfig(), 100 step-2 iterations, at bench shape, with
        CLICK_CONFIG's penalties, and at B = 1 on the opti_node map
        (chip_smoke.py phase 7): events around 3 back-to-back launches,
        over 3, min of 5; at bench shape also one call between events, the
        host's wrapper inside (chip_smoke.py's ``ms``), min of 5;
  K2    one launch on 1024 x 180 positions: device time from a CUDA graph
        of 100 launches replayed between two events (min of 5), the same
        100 launches enqueued one by one from the host, and the wrapper's
        host time per call.

The variants run in turn, then again in reverse order; each time is the
smaller of the two.  It also times a pass that builds a z-pair (float2)
copy of the bench fields, the corner layout that would halve the loads.
Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/k2_probe.py [--baseline DIR] [--out PATH]

It prints the card and its power limit, ptxas's registers and spills for
each variant, the times, the lookup's share of a K3 iteration split into
loads and arithmetic, and writes the same as JSON to PATH (default
build/k2_probe.json, which .gitignore lists).
"""

import argparse
import concurrent.futures
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from grad_traj_optimization_torch import _build  # noqa: E402

HEADER = "trilinear.cuh"
INCLUDE = "#include <cuda_runtime.h>\n"
CORNER = ("__device__ __forceinline__ float gto_probe_corner(const float* p) "
          "{\n  return static_cast<float>((reinterpret_cast<size_t>(p) >> 2) "
          "& 63) * 0.125f;\n}\n")
#: a header with the lookup frame divides in gto_div_fast; an older one
#: calls __fdiv_rn(x, res) at each of the nine divisions
DIV = "float gto_div_fast(float a, const GtoFrame& f) {\n"
MUL_DIV = "  return __fmul_rn(a, f.rcp);\n"
IEEE_DIV = "  return __fdiv_rn(a, f.res);\n"
RCP_DIV = "#define gto_probe_div(a, b) __fmul_rn((a), __frcp_rn(b))\n"
#: the lookup's one range check (a failed check reruns it with
#: __fdiv_rn), and its fast division; gto_div checks one dividend and
#: branches to __fdiv_rn: a check at each division, not one a lookup
GUARD_RET = "  return guard.ok();\n"
FAST_DIV = "      guard.add(a);\n      return gto_div_fast(a, f);\n"
EACH_DIV = "      return gto_div(a, f);\n"
BODY = "float* gz) {\n"
NO_LOOKUP = "  *d = 1.0f;\n  *gx = *gy = *gz = 0.0f;\n  return;\n"
#: the entry points every variant, and a parent's library, exports
ENTRIES = ("gto_minplus_axis", "gto_trilinear_batch", "gto_descend",
           "gto_descend_plan")


def variants(src):
    def edit(pairs):
        text = src
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{HEADER} no longer holds {old!r}")
            text = text.replace(old, new)
        return text

    framed = DIV in src
    out = {
        "as is": src,
        "synthetic corners": edit([(INCLUDE, INCLUDE + CORNER),
                                   ("__ldg(", "gto_probe_corner(")]),
        "multiply, not divide": edit(
            [(DIV, DIV + MUL_DIV)] if framed else
            [(INCLUDE, INCLUDE + RCP_DIV), ("__fdiv_rn(", "gto_probe_div(")]),
        "no lookup": edit([(BODY, BODY + NO_LOOKUP)]),
    }
    if framed:
        out["IEEE division"] = edit([(DIV, DIV + IEEE_DIV)])
        out["no range check"] = edit([(GUARD_RET, "  return true;\n")])
        out["branch at each division"] = edit([(FAST_DIV, EACH_DIV)])
    return out


def ptxas_summary(log):
    """{kernel: 'N registers, S bytes spill stores'} from nvcc -Xptxas -v
    (per kernel: 'Compiling entry function', its stack line, 'Used')."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            for short in ("descend", "trilinear", "minplus", "div_check"):
                if short in name:
                    name = short
        elif name and "spill stores" in line:
            spill = line.split("stack frame, ")[1].split(",")[0].strip()
        elif name and "Used" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            out[name] = f"{regs}, {spill}"
            name, spill = None, ""
    return out


def build(idx, name, csrc, header_text, tmp):
    """Copy csrc into a directory of its own, replace the header's text
    and build the library there."""
    vdir = os.path.join(tmp, f"v{idx}")
    shutil.copytree(csrc, vdir)
    with open(os.path.join(vdir, HEADER), "w") as fh:
        fh.write(header_text)
    so = os.path.join(vdir, "lib.so")
    cu = sorted(glob.glob(os.path.join(vdir, "*.cu")))
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                           *cu], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: {proc.stderr[-3000:]}")
    return name, so, ptxas_summary(proc.stdout + proc.stderr)


def bench_inputs(dev):
    """The bench fields, phase 4's positions, and K3's inputs: phase 5's
    with OptimizerConfig() and with CLICK_CONFIG, and phase 7's B = 1 on
    the opti_node map."""
    import grad_traj_optimization_torch as gto
    from grad_traj_optimization_torch import config, fixtures, solver
    from grad_traj_optimization_torch.fields import sdf

    B = chip_smoke.BATCH
    map_cfg, pts, valid, wps = fixtures.random_scenarios(
        B, n_waypoints=chip_smoke.N_WP, seed=chip_smoke.SEED,
        max_obstacle_points=4096)
    origin = torch.tensor(map_cfg.origin, dtype=torch.float32, device=dev)
    occ = sdf.rasterize(torch.as_tensor(pts, dtype=torch.float32, device=dev),
                        origin, map_cfg.resolution, map_cfg.grid_shape,
                        valid_mask=torch.as_tensor(valid, device=dev))
    dist = sdf.edt_batch(occ, map_cfg.resolution)
    org_b = origin.expand(B, 3).contiguous()
    res_b = torch.full((B,), map_cfg.resolution, dtype=torch.float32,
                       device=dev)
    pos = torch.as_tensor(
        fixtures.lookup_queries(map_cfg, B, chip_smoke.SEED), device=dev)
    scns = solver.Scenario(
        dist=dist, origin=org_b, resolution=res_b,
        waypoints=torch.as_tensor(wps, dtype=torch.float32, device=dev))
    cfg = gto.OptimizerConfig()
    click = config.CLICK_CONFIG
    mc, obss, wp = fixtures.opti_node_scenario()
    scn = solver.make_scenario(wp, obss, mc, device=dev)
    one = scn.map(lambda x: x[None])
    k3 = {"k3_ms": (solver.kernel_inputs(scns, cfg)[0], cfg),
          "k3_click_ms": (solver.kernel_inputs(scns, click)[0], click),
          "k3_b1_ms": (solver.kernel_inputs(one, cfg)[0], cfg)}
    return dist, (dist, org_b, res_b, pos), k3


def pair_copy(dist):
    """The z-pair layout: (..., nz, 2) = (v[z], v[min(z + 1, nz - 1)])."""
    out = torch.empty(dist.shape + (2,), dtype=dist.dtype, device=dist.device)
    out[..., 0].copy_(dist)
    out[..., :-1, 1].copy_(dist[..., 1:])
    out[..., -1, 1].copy_(dist[..., -1])
    return out


def shares(v, prefix, iters):
    """The lookup's share of one K3 launch from the variants' times."""
    base = v[prefix + "as is"]["k3_ms"]
    share = {
        "lookup": (base - v[prefix + "no lookup"]["k3_ms"]) / base,
        "loads": (base - v[prefix + "synthetic corners"]["k3_ms"]) / base,
        "divisions": (base - v[prefix + "multiply, not divide"]["k3_ms"])
        / base,
    }
    share["arithmetic"] = share["lookup"] - share["loads"]
    return base * 1e3 / iters, share


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="another csrc/ directory whose "
                    "header's variants are built and timed too")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "k2_probe.json"),
                    help="where to write the report as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from grad_traj_optimization_torch.ops import solve_cuda, trilinear_cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    tag = f"[{card}]"
    sources = [("", _build.CSRC_DIR)]
    if args.baseline:
        sources.append(("baseline ", os.path.abspath(args.baseline)))
    jobs = []
    for prefix, csrc in sources:
        with open(os.path.join(csrc, HEADER)) as fh:
            src = fh.read()
        jobs += [(prefix + name, csrc, text)
                 for name, text in variants(src).items()]
    report = {"card": card, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor() as pool:
            built = list(pool.map(lambda j: build(j[0], *j[1], tmp),
                                  enumerate(jobs)))
        libs = {name: _build.open_library(so, ENTRIES)
                for name, so, _ in built}
        for name, _, regs in built:
            print(f"{name:30s} ptxas: " + "; ".join(
                f"{k} {v}" for k, v in sorted(regs.items())), flush=True)
            report["variants"][name] = {"ptxas": regs}
        dev = torch.device("cuda:0")
        with _build.using(libs["as is"]):  # K1 for the fields: as is
            dist, k2_args, k3 = bench_inputs(dev)

        def descend(kargs, cfg):
            return solve_cuda.descend(*kargs, ((2, cfg.iters_step2),), cfg)
        outputs = {}
        order = list(libs) + list(reversed(libs))
        times = {name: {} for name in libs}
        for name in order:
            with _build.using(libs[name]):
                outputs[name] = ({k: descend(*a) for k, a in k3.items()},
                                 trilinear_cuda.trilinear_batch(*k2_args))
                t = {k: chip_smoke.stream_ms(lambda: descend(*a))
                     for k, a in k3.items()}
                t["k3_call_ms"] = chip_smoke.gpu_ms(
                    lambda: descend(*k3["k3_ms"]), reps=5)
                t.update({
                    "k2_graph_ms": chip_smoke.graph_ms(
                        lambda: trilinear_cuda.trilinear_batch(*k2_args)),
                    "k2_stream_ms": chip_smoke.stream_ms(
                        lambda: trilinear_cuda.trilinear_batch(*k2_args),
                        100),
                    "k2_host_ms": chip_smoke.host_ms(
                        lambda: trilinear_cuda.trilinear_batch(*k2_args)),
                })
            for k, v in t.items():
                times[name][k] = min(times[name].get(k, math.inf), v)
        iters = k3["k3_ms"][1].iters_step2
        for name in libs:
            t = times[name]
            report["variants"][name].update(t)
            print(f"{name:30s} K3 {t['k3_ms']:.4f} ms "
                  f"({t['k3_ms'] * 1e3 / iters:.2f} us an iteration; one "
                  f"call {t['k3_call_ms']:.4f} ms), "
                  f"CLICK {t['k3_click_ms']:.4f} ms, B=1 opti_node "
                  f"{t['k3_b1_ms']:.4f} ms; K2 device "
                  f"{t['k2_graph_ms'] * 1e3:.2f} us "
                  f"(graph of 100), enqueued one by one "
                  f"{t['k2_stream_ms'] * 1e3:.2f} us, wrapper host "
                  f"{t['k2_host_ms'] * 1e3:.2f} us {tag}", flush=True)
    if args.baseline:
        (k3a, k2a), (k3b, k2b) = outputs["as is"], outputs["baseline as is"]

        def bitwise(x, y):
            return torch.equal(x.view(torch.int32), y.view(torch.int32))

        same = {k: {f: bitwise(x, y) for f, x, y in zip(
            ("dp", "cost", "n_accept", "trace"), k3a[k], k3b[k])}
            for k in k3}
        same_k2 = all(bitwise(x, y) for x, y in zip(k2a, k2b))
        lanes = int((k3a["k3_ms"][1] == k3b["k3_ms"][1]).sum())
        report["baseline_bitwise"] = {"k3": same, "k3_equal_cost_lanes": lanes,
                                      "k2": same_k2}
        print(f"as is vs baseline as is, bitwise: K3 {same} (bench cost "
              f"equal on {lanes}/{k3a['k3_ms'][1].numel()} lanes), K2 "
              f"{same_k2}", flush=True)

    v = report["variants"]
    report["k3_share"] = {}
    for prefix, _ in sources:
        it_us, share = shares(v, prefix, iters)
        report["k3_share"][prefix + "as is"] = share
        print(f"lookup share of K3, {prefix}as is ({it_us:.2f} us an "
              "iteration): " + ", ".join(
                  f"{k} {100 * s:.1f}% ({s * it_us:.2f} us)"
                  for k, s in share.items()) + f" {tag}", flush=True)

    pair_ms = chip_smoke.gpu_ms(lambda: pair_copy(dist), reps=5)
    saved = v["as is"]["k3_ms"] - v["synthetic corners"]["k3_ms"]
    report["pair_copy_ms"] = pair_ms
    report["pair_copy_bound_ms"] = 3 * 4 * dist.numel() / chip_smoke.HBM_BPS \
        * 1e3
    print(f"z-pair copy of the bench fields {pair_ms:.3f} ms (bound "
          f"{report['pair_copy_bound_ms']:.3f} ms: 1x read, 2x written) vs at "
          f"most {saved:.3f} ms that the loads cost one K3 launch {tag}",
          flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
