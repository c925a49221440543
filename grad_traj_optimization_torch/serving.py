"""Micro-batching front doors for the batched solver (port of
``grad_traj_optimization_tpu.serving``).

The reference serves one solve per ROS callback (src/opti_node.cpp:
47-147; compare2.cpp's handshake :129-137).  The card is fastest when
many scenarios ride one K3 launch, so a server aggregates concurrent
requests into batches without letting any request wait unboundedly:

* requests enqueue from any thread (``submit`` returns a Future);
* one dispatch thread drains the queue into a batch, bounded by
  ``max_batch`` and a ``max_wait_ms`` deadline from the OLDEST queued
  request;
* batches pad up to power-of-two buckets (replicating the last request;
  pad lanes are dropped on return), decomposed into groups of pow2
  sizes (``SolveServer._bucket_groups``), one K3 launch a group;
* all requests share one (grid shape, waypoint count) contract; a
  mismatching scenario is rejected at ``submit``;
* when every request of a group holds the SAME distance-field tensor,
  the group is solved in shared-map form (``dist`` leading dim 1).

Kernels launch from the dispatch thread on the current stream of the
tensors' device.  Futures resolve to results on the host: a
``Solution`` of numpy arrays, batch axis stripped.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from grad_traj_optimization_torch import native
from grad_traj_optimization_torch import solver as solve_mod
from grad_traj_optimization_torch.config import OptimizerConfig


def _safe_resolve(fut: Future, result=None, exception=None):
    """Resolve a future without killing the dispatch thread.

    A client ``cancel()`` racing the dispatch makes ``set_result`` /
    ``set_exception`` raise InvalidStateError, which would end ``_run``
    and hang every later submit.  ``set_running_or_notify_cancel`` claims
    the future first (False: cancelled, nothing to resolve; True: a
    concurrent cancel can no longer land).
    """
    try:
        if not fut.set_running_or_notify_cancel():
            return  # client cancelled before dispatch claimed it
        if exception is not None:
            fut.set_exception(exception)
        else:
            fut.set_result(result)
    except Exception:  # noqa: BLE001 — InvalidStateError et al.
        pass


@dataclasses.dataclass
class ServerStats:
    n_requests: int = 0
    n_batches: int = 0
    n_padded_lanes: int = 0
    batch_sizes: list = dataclasses.field(default_factory=list)
    wait_ms: list = dataclasses.field(default_factory=list)   # queue wait
    total_ms: list = dataclasses.field(default_factory=list)  # submit->done
    assemble_ms: list = dataclasses.field(default_factory=list)  # per batch
    device_ms: list = dataclasses.field(default_factory=list)    # per batch
    solve_ms: list = dataclasses.field(default_factory=list)     # instrument
    download_ms: list = dataclasses.field(default_factory=list)  # instrument

    def summary(self) -> dict:
        def pct(a, q):
            return float(np.percentile(a, q)) if a else 0.0

        return {
            "n_requests": self.n_requests,
            "n_batches": self.n_batches,
            "mean_batch": (
                float(np.mean(self.batch_sizes)) if self.batch_sizes else 0.0
            ),
            "pad_fraction": (
                self.n_padded_lanes
                / max(sum(self.batch_sizes) + self.n_padded_lanes, 1)
            ),
            "wait_ms_p50": pct(self.wait_ms, 50),
            "wait_ms_p99": pct(self.wait_ms, 99),
            "total_ms_p50": pct(self.total_ms, 50),
            "total_ms_p99": pct(self.total_ms, 99),
            "assemble_ms_p50": pct(self.assemble_ms, 50),
            "device_ms_p50": pct(self.device_ms, 50),
            "device_ms_p99": pct(self.device_ms, 99),
            "solve_ms_p50": pct(self.solve_ms, 50),
            "download_ms_p50": pct(self.download_ms, 50),
        }


def _to_host(sol) -> solve_mod.Solution:
    """A batched Solution on the host: one ``.cpu()`` per field."""
    return solve_mod.Solution(*(x.cpu().numpy() for x in sol))


def _lane(host: solve_mod.Solution, i: int) -> solve_mod.Solution:
    return solve_mod.Solution(*(x[i] for x in host))


class _MicroBatcher:
    """Shared queue + aggregation-deadline dispatch machinery.  Queue
    entries are ``(*payload, fut, t0)`` tuples (future at [-2], enqueue
    time at [-1]); subclasses implement ``_dispatch(batch)`` and call
    :meth:`_start_batcher` at the end of their ``__init__``."""

    def _start_batcher(self):
        self.stats = ServerStats()
        self._queue: list = []
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _enqueue(self, entry) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("server is shut down")
            self._queue.append(entry)
            self._cv.notify()

    def shutdown(self, wait: bool = True):
        with self._cv:
            self._closed = True
            self._cv.notify()
        if wait:
            self._worker.join()

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                # aggregation: wait out the deadline of the OLDEST
                # request (or until the batch fills)
                t_oldest = self._queue[0][-1]
                while len(self._queue) < self.max_batch and not self._closed:
                    remaining = (
                        self.max_wait_ms / 1e3
                        - (time.perf_counter() - t_oldest)
                    )
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch = self._queue[: self.max_batch]
                del self._queue[: self.max_batch]
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — keep the worker alive
                for entry in batch:
                    _safe_resolve(entry[-2], exception=e)

    def _record(self, batch, n, pads, t_dispatch, t_assembled, t_done,
                t_solved=None):
        """Stats of one dispatched batch, recorded BEFORE its futures
        resolve (a client woken by ``result()`` may read or reset them)."""
        with self._cv:
            st = self.stats
            st.n_requests += n
            st.n_batches += 1
            st.n_padded_lanes += pads
            st.batch_sizes.append(n)
            st.assemble_ms.append((t_assembled - t_dispatch) * 1e3)
            st.device_ms.append((t_done - t_assembled) * 1e3)
            if t_solved is not None:
                st.solve_ms.append((t_solved - t_assembled) * 1e3)
                st.download_ms.append((t_done - t_solved) * 1e3)
            for entry in batch:
                st.wait_ms.append((t_dispatch - entry[-1]) * 1e3)
                st.total_ms.append((t_done - entry[-1]) * 1e3)


def _pow2(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class SolveServer(_MicroBatcher):
    """Micro-batching solve server over one device.

    Args:
      cfg/steps: optimizer schedule for every request.
      max_batch: hard batch-size cap (also the largest pad bucket).
      max_wait_ms: aggregation deadline from the oldest queued request.
      pad_buckets: round group sizes up to powers of two (the launch
        count and the padded lanes follow the JAX package's).
      bucket_floor: the smallest group of a decomposed batch.
      device: where numpy leaves of submitted scenarios go (tensor leaves
        keep their device); the card unless the caller asks for the CPU.
    """

    def __init__(
        self,
        cfg: OptimizerConfig = OptimizerConfig(),
        steps=(2,),
        max_batch: int = 256,
        max_wait_ms: float = 5.0,
        pad_buckets: bool = True,
        bucket_floor: int = 128,
        device="cuda",
    ):
        self.cfg = cfg
        self.steps = tuple(steps)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.pad_buckets = bool(pad_buckets)
        self.bucket_floor = int(bucket_floor)
        self.device = torch.device(device)
        self._contract = None  # (grid_shape, n_wp) fixed by first submit
        self._start_batcher()

    # -- client surface ---------------------------------------------------

    def submit(self, scenario: solve_mod.Scenario) -> Future:
        """Enqueue one (unbatched) Scenario; returns a Future resolving
        to its Solution (numpy leaves, batch axis stripped).  A cropped
        scenario raises ValueError, as in the JAX package."""
        solve_mod.require_uncropped(scenario, "submit()")
        key = (tuple(scenario.dist.shape), int(scenario.waypoints.shape[0]))
        fut: Future = Future()
        with self._cv:
            if self._contract is None:
                self._contract = key
            elif key != self._contract:
                raise ValueError(
                    f"scenario shape {key} != server contract "
                    f"{self._contract}; route each (grid, n_wp) bucket "
                    "to its own SolveServer"
                )
        self._enqueue((scenario, fut, time.perf_counter()))
        return fut

    def solve(self, scenario, timeout: float | None = None):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(scenario).result(timeout=timeout)

    # -- dispatch ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        return _pow2(n, self.max_batch) if self.pad_buckets else n

    def _bucket_groups(self, n: int) -> list[int]:
        """Decompose a batch into pow2 group sizes, one K3 launch each.

        A single pow2 bucket pads up to ~50% dead lanes; a greedy
        decomposition into descending pow2 groups with a ``bucket_floor``
        floor (720 -> 512 + 128 + 128, pad 6.7%) trades a few launches for
        the dead lanes.  When it saves no padding over the single covering
        bucket (n = 1000 -> groups totaling 1024), the single bucket wins.
        """
        if not self.pad_buckets:
            return [n]
        floor = min(self.bucket_floor, self.max_batch)
        single = self._bucket(n)
        if n <= floor or n > self.max_batch - floor // 2:
            return [single]
        groups, rem = [], n
        while rem > 0:
            b = self._bucket(rem)
            if b > rem and b > floor:
                groups.append(b // 2)
                rem -= b // 2
            else:
                groups.append(max(b, floor))
                rem -= b
        if sum(groups) >= single:
            return [single]  # no padding saved -> one launch
        return groups

    def _stack(self, leaves):
        """One batched leaf on the device of the first: one object for all
        lanes broadcasts (no copies), others stack."""
        l0 = leaves[0]
        dev = self._dev(l0)
        if all(x is l0 for x in leaves):
            t = torch.as_tensor(l0, device=dev)
            return t.expand(len(leaves), *t.shape)
        return torch.stack([torch.as_tensor(x, device=dev) for x in leaves])

    def _dev(self, leaf):
        return leaf.device if isinstance(leaf, torch.Tensor) else self.device

    def _dispatch(self, batch):
        t_dispatch = time.perf_counter()
        scns = [b[0] for b in batch]
        futs = [b[1] for b in batch]
        n = len(scns)
        groups = self._bucket_groups(n)
        pads = sum(groups) - n
        try:
            # assemble and launch every group first (asynchronous on the
            # card), then synchronise and download
            sols = []
            ofs = 0
            for g in groups:
                sub = scns[ofs:ofs + g]
                ofs += min(g, n - ofs)
                sub = sub + [scns[-1]] * (g - len(sub))
                first = sub[0].dist
                if all(s.dist is first for s in sub):
                    dist = torch.as_tensor(first,
                                           device=self._dev(first))[None]
                else:
                    dist = self._stack([s.dist for s in sub])
                scn_b = solve_mod.Scenario(
                    dist=dist,
                    origin=self._stack([s.origin for s in sub]),
                    resolution=self._stack([s.resolution for s in sub]),
                    waypoints=self._stack([s.waypoints for s in sub]),
                )
                sols.append(solve_mod.solve_batch(scn_b, cfg=self.cfg,
                                                  steps=self.steps))
            t_assembled = time.perf_counter()
            # the stats' device-time barrier: solve apart from download
            if sols[-1].cost.device.type == "cuda":
                torch.cuda.current_stream(sols[-1].cost.device).synchronize()
            t_solved = time.perf_counter()
            hosts = [_to_host(s) for s in sols]
            host = hosts[0] if len(hosts) == 1 else solve_mod.Solution(
                *(np.concatenate(xs, axis=0) for xs in zip(*hosts)))
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            for f in futs:
                _safe_resolve(f, exception=e)
            return
        t_done = time.perf_counter()
        self._record(batch, n, pads, t_dispatch, t_assembled, t_done,
                     t_solved)
        for i, f in enumerate(futs):
            _safe_resolve(f, result=_lane(host, i))


class MissionServer(_MicroBatcher):
    """Micro-batching full-mission server: search + refine per request.

    The mission analogue of :class:`SolveServer` (the reference's online
    surface is one full mission per callback, compare2.cpp:129-177):
    requests are (start, goal) states against ONE shared distance field;
    the dispatch thread drains them into pow2-padded batches of
    :func:`pipeline.plan_batch` (retry-ladder search, raced refine,
    optional exact host-A* rung).

    ``dist`` goes to ``device`` (the card unless the caller asks for the
    CPU).  With ``host_fallback`` the native engine is built here, or the
    constructor raises.  Each Future resolves to a dict with the lane's
    ``solution`` (numpy Solution, batch axis stripped), ``reached`` and
    ``ok``.
    """

    def __init__(
        self,
        dist,
        origin,
        resolution: float,
        cfg: OptimizerConfig = OptimizerConfig(),
        max_batch: int = 256,
        max_wait_ms: float = 5.0,
        host_fallback: bool = False,
        device="cuda",
        **plan_kw,
    ):
        self.dist = torch.as_tensor(dist, dtype=torch.float32, device=device)
        if self.dist.dim() == 3:
            self.dist = self.dist[None]
        if self.dist.shape[0] != 1:
            raise ValueError(
                "MissionServer serves ONE shared field; got dist "
                f"leading dim {self.dist.shape[0]} — pass dist[:1] "
                "(per-request fields need per-(grid) servers)"
            )
        if host_fallback:
            native.load()
        self.origin = np.asarray(origin, np.float32)
        self.resolution = float(resolution)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.host_fallback = bool(host_fallback)
        self.plan_kw = plan_kw
        self._start_batcher()

    def submit(self, start_state, goal_state) -> Future:
        """Enqueue one mission ((6,) start / goal = [p, v])."""
        s = np.asarray(start_state, np.float32).reshape(6)
        g = np.asarray(goal_state, np.float32).reshape(6)
        fut: Future = Future()
        self._enqueue((s, g, fut, time.perf_counter()))
        return fut

    def _dispatch(self, batch):
        from grad_traj_optimization_torch import pipeline

        t_dispatch = time.perf_counter()
        n = len(batch)
        target = _pow2(n, self.max_batch)
        pads = target - n
        starts = np.stack([x[0] for x in batch] + [batch[-1][0]] * pads)
        goals = np.stack([x[1] for x in batch] + [batch[-1][1]] * pads)
        futs = [x[2] for x in batch]
        t_assembled = time.perf_counter()
        try:
            res = pipeline.plan_batch(
                self.dist, self.origin,
                self.resolution, starts, goals, cfg=self.cfg,
                host_fallback=self.host_fallback, **self.plan_kw,
            )
            host = _to_host(res.solution)
        except Exception as e:  # noqa: BLE001
            for f in futs:
                _safe_resolve(f, exception=e)
            return
        t_done = time.perf_counter()
        self._record(batch, n, pads, t_dispatch, t_assembled, t_done)
        for i, f in enumerate(futs):
            _safe_resolve(f, result={
                "solution": _lane(host, i),
                "reached": bool(res.reached[i]),
                "ok": bool(res.ok[i]),
            })
