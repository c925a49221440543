"""What the drivers share: the closed loop, the seeded sample of answers
kept for the check, and the program's objects built from a configuration."""

from __future__ import annotations

import time

import numpy as np
import torch


class Reservoir:
    """A uniform sample of ``k`` of all the items offered, drawn from ``rng``
    (algorithm R, a batch of items at a time); ``make(i)`` builds item i of
    a batch only when it is kept."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, idx, make):
        idx = np.asarray(idx)
        fill = min(max(self.k - len(self.items), 0), len(idx))
        self.items += [make(int(i)) for i in idx[:fill]]
        rest = idx[fill:]
        if len(rest):
            j = self.rng.integers(0, self.seen + fill + 1 + np.arange(len(rest)))
            slots = {}
            for t in np.flatnonzero(j < self.k):  # later items overwrite
                slots[int(j[t])] = int(rest[t])
            for slot, i in slots.items():
                self.items[slot] = make(i)
        self.seen += len(idx)


def optimizer(config: dict):
    from grad_traj_optimization_torch.config import OptimizerConfig
    return OptimizerConfig(**config["optimizer"])


class ClosedLoop:
    """A client that sends its next batch when the last one has returned.
    Subclasses define ``step()`` -> (lanes ok, lanes failed); a lane is
    counted where it came back ok, over all the window's time, under the
    name the traffic file gives (``rate_metric``)."""

    def window(self, seconds: float, tracer=None):
        self.lanes = self.failed = self.batches = 0
        if tracer is not None:
            tracer.start()
        t0 = last = time.perf_counter()
        self.batch_s = []
        while True:
            n, bad = self.step()
            self.lanes += n
            self.failed += bad
            self.batches += 1
            if tracer is not None and tracer.due():
                tracer.stop()
            now = time.perf_counter()
            self.batch_s.append(now - last)
            last = now
            if now - t0 >= seconds:
                break
        self.elapsed = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop()

    def diagnostics(self) -> dict:
        """The batches' host seconds: their spread within one window,
        against which the spread between runs is read."""
        b = np.asarray(self.batch_s)
        return {"batches": len(b), "batch_s_mean": float(b.mean()),
                "batch_s_std": float(b.std()), "batch_s_max": float(b.max())}

    def counts(self):
        return self.lanes + self.failed, self.failed

    def end_to_end(self) -> dict:
        return {self.cell.traffic["rate_metric"]: self.lanes / self.elapsed}


def take(x, i):
    """Lane ``i`` of a batched tensor, copied on its device."""
    return x[i].clone()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
