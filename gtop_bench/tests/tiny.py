"""A copy of the benchmark's data at a tiny size, for runs on the CPU with
the kernels' plain versions: the same cells, drivers, metrics and checks,
on small maps, small batches and short budgets.

Each configuration and each kind of traffic that ``BENCHMARK.json`` names
has its tiny size in a file named after it, whose keys replace the full
file's: ``tiny/configs/<config>.json`` and ``tiny/traffic/<traffic>.json``
beside this module.  A name without one is refused, so that no cell runs
at full size on the CPU."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TINY = os.path.join("gtop_bench", "tests", "tiny")


def _json(path):
    with open(path) as f:
        return json.load(f)


def overrides(src: str = ROOT) -> list:
    """(file to shrink, tiny file) for every configuration and traffic
    that ``src``'s BENCHMARK.json names, relative to ``src``; raises
    FileNotFoundError naming every tiny file that is missing."""
    bench = _json(os.path.join(src, "BENCHMARK.json"))
    pairs = [(c["file"], os.path.join(TINY, "configs", c["name"] + ".json"))
             for c in bench["configs"]]
    pairs += [(os.path.join("gtop_bench", "traffic", t + ".json"),
               os.path.join(TINY, "traffic", t + ".json"))
              for t in sorted({w["traffic"] for w in bench["workloads"]})]
    missing = [t for _, t in pairs if not os.path.exists(os.path.join(src, t))]
    if missing:
        raise FileNotFoundError(
            "no tiny size for the CPU tests: add " + ", ".join(missing))
    return pairs


def make_root(dst: str, src: str = ROOT) -> str:
    """``dst`` holding ``src``'s BENCHMARK.json and gtop_bench's data at
    tiny size."""
    pairs = overrides(src)
    shutil.copy(os.path.join(src, "BENCHMARK.json"), dst)
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(src, "gtop_bench", sub),
                        os.path.join(dst, "gtop_bench", sub))
    for full, tiny in pairs:
        path = os.path.join(dst, full)
        d = _json(path)
        d.update(_json(os.path.join(src, tiny)))
        with open(path, "w") as f:
            json.dump(d, f, indent=1)
    return dst
