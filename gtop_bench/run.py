"""Run one benchmark cell of the PyTorch/CUDA trajectory optimizer.

    python3 gtop_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernels' build on a checkout's first run, the
cell's inputs made from the seed, every shape warmed) is timed from the
process's start; then the cell's driver runs its traffic for ``--seconds``
and the outputs it kept are compared with the plain reference.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, ``setup_parts`` (the seconds of set-up's phases: imports,
the look for a card, the CUDA context, the kernels' library, which nvcc
builds on a checkout's first run, and the inputs with the warm batches),
and last
``checks``, each compared number beside its limit.
Without a CUDA card, or with fewer cards than the cell needs, it prints
no result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache of the program lives inside the checkout, at a fixed path
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level modules that must not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "grad_traj_optimization_tpu")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t0: float = None, control: bool = False, marks=()) -> dict:
    """Set up, run the window, check; the result line as a dict.  With
    ``control`` the kept inputs are answered by the reference in the
    control precision instead of the program (not run by the benchmark).
    Set-up runs from ``t0``; ``marks`` are (name, time) of the phases
    that the caller ran since."""
    import torch

    from gtop_bench import spec, trace

    t0 = time.perf_counter() if t0 is None else t0
    parts, mark = {}, [t0]
    for name, t in marks:
        parts[name] = t - mark[0]
        mark[0] = t

    def lap(name):
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    lap("harness_s")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spans = trace.Spans(traced, dev)
    drv = spec.driver(cell.traffic["driver"]).Driver(
        cell, seed, dev, spans, seconds)
    if cuda:
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        lap("context_s")
        # the kernels' library: nvcc builds it on a checkout's first run
        from grad_traj_optimization_torch import _build
        _build.load()
        lap("build_s")
    drv.setup()
    if cuda:
        torch.cuda.synchronize(dev)
    lap("inputs_warm_s")
    setup_s = time.perf_counter() - t0
    tracer = trace.DeviceTrace(cell.traffic["trace_seconds"]) if traced else None
    drv.window(seconds, tracer)
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    attempted, failed = drv.counts()
    if hasattr(drv, "diagnostics"):
        _log("window: " + json.dumps(drv.diagnostics()))
    e2e = dict(drv.end_to_end(), setup_s=setup_s)
    tr = tracer.finish() if traced else None
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    with torch.no_grad():
        nums = drv.numbers(control=control)
    _log(f"reference check took {time.perf_counter() - t_check:.1f} s")

    # the numbers the cell's limits name are compared; a number the
    # comparison could not read (NaN) is null, and fails
    for k, v in nums.items():
        _log(f"reading {k} {v!r}")
    checks = {k: {"value": v if v == v and abs(v) != float("inf") else None,
                  "limit": lim}
              for k, v in nums.items()
              if (lim := cell.limits.get(k)) is not None}
    correct = attempted > failed and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())

    run = types.SimpleNamespace(cell=cell, driver=drv, spans=spans.times,
                                trace=tr, setup_s=setup_s)
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = spec.reader(m["name"], cell.root)(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics,
           "device": {"platform": "gpu" if cuda else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if traced:
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["setup_parts"] = parts
    out["readings"] = nums
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from gtop_bench import spec

    t_import = time.perf_counter()
    if not torch.cuda.is_available():
        _log("no CUDA device: this benchmark measures the card and has no CPU run")
        return 2
    cell = spec.cell(a.workload)
    if torch.cuda.device_count() < cell.entry["chips"]:
        _log(f"{a.workload} needs {cell.entry['chips']} cards, "
             f"{torch.cuda.device_count()} visible")
        return 2
    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", t0=T0,
                   marks=(("import_s", t_import),
                          ("cuda_probe_s", time.perf_counter())))
    bad = forbidden_loaded()
    if bad:
        _log(f"forbidden modules loaded in the measured process: {bad}")
        return 3
    _log("setup: " + json.dumps(out["setup_parts"]))
    for k, c in out["checks"].items():
        _log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    del out["readings"]  # logged above; the result line ends with its checks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
