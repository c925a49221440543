"""Projected descent under box bounds (port of
``grad_traj_optimization_tpu.opt.descent``).

Replaces the reference's NLopt back-end (grad_traj_optimizer.cpp:
135-195) with a deterministic fixed iteration budget:

* iterates are clipped to [lb, ub] after every step (the exact
  projection onto a box);
* "bb" steps are Barzilai-Borwein ``|<s, y>| / <y, y>`` from the last
  accepted pair, clipped to [lr_min, lr_max], shrunk by ``lr_shrink``
  while rejected (floor 1e-8); "adaptive" grows/shrinks a normalized
  step;
* a candidate is accepted if it beats the max of the last
  ``accept_window`` accepted costs (1 = strictly monotone);
* the best iterate is carried separately, so the returned dp, cost and
  cost trace (the reference's getCostCurve, :438-447) are monotone-best.

One fused cost+gradient evaluation per iteration; the gradient of an
unchanged iterate is reused across rejected steps.  Each evaluation of
:func:`minimize_batch` is counted (``utils.profiling``): one under
``descent.evals`` and the batch's B under ``descent.lanes``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from grad_traj_optimization_torch.config import OptimizerConfig
from grad_traj_optimization_torch.utils import profiling


class DescentResult(NamedTuple):
    dp: torch.Tensor          # optimized free derivatives
    cost: torch.Tensor        # final (best) cost
    n_accept: torch.Tensor    # accepted iterations
    cost_trace: torch.Tensor  # (iters,) or (B, iters) monotone envelope


def minimize(
    cost_and_grad: Callable,
    cost_only: Callable,
    dp0,
    lb,
    ub,
    iters: int,
    cfg: OptimizerConfig,
    record_trace: bool = True,
) -> DescentResult:
    """Run ``iters`` projected-descent iterations from one dp0.

    ``cost_and_grad(dp) -> (cost, grad)`` closes over the scenario.
    ``cost_only`` is accepted for signature parity with the JAX package,
    which also never calls it.
    """
    res = minimize_batch(
        lambda dp: tuple(v[None] for v in cost_and_grad(dp[0])),
        dp0[None], lb[None], ub[None], iters, cfg,
        record_trace=record_trace,
    )
    return DescentResult(*(v[0] for v in res))


def minimize_batch(
    cost_and_grad: Callable,
    dp0,
    lb,
    ub,
    iters: int,
    cfg: OptimizerConfig,
    record_trace: bool = False,
) -> DescentResult:
    """Batch-first descent: ``cost_and_grad(dp) -> (cost (B,), grad)``
    with dp0/lb/ub (B, ...); acceptance, steps and BB pairs are per
    scenario."""
    dp = torch.clamp(dp0, lb, ub)
    B = dp.shape[0]
    use_bb = cfg.step_rule == "bb"
    W = cfg.accept_window
    red = tuple(range(1, dp.dim()))

    def bshape(v):
        return v.reshape((B,) + (1,) * (dp.dim() - 1))

    def evaluate(x):
        profiling.add("descent.evals")
        profiling.add("descent.lanes", B)
        return cost_and_grad(x)

    c0, grad = evaluate(dp)
    gnorm = torch.sqrt(torch.sum(grad * grad, dim=red))
    if use_bb:
        lr = cfg.lr0 / (gnorm + 1e-12)
    else:
        lr = torch.full((B,), cfg.lr0, dtype=dp.dtype, device=dp.device)
    scale = torch.ones((B,), dtype=dp.dtype, device=dp.device)
    hist = c0[:, None].expand(B, W).clone()
    ptr = torch.zeros((B,), dtype=torch.int64, device=dp.device)
    best_c, best_dp = c0, dp
    n_acc = torch.zeros((B,), dtype=torch.int32, device=dp.device)
    slots = torch.arange(W, device=dp.device)
    trace = []
    for _ in range(iters):
        if use_bb:
            step = bshape(lr * scale)
        else:
            step = bshape(lr) / bshape(
                torch.sqrt(torch.sum(grad * grad, dim=red)) + 1e-12
            )
        cand = torch.clamp(dp - step * grad, lb, ub)
        c2, g2 = evaluate(cand)
        accept = c2 < torch.amax(hist, dim=1)
        if use_bb:
            s = cand - dp
            y = g2 - grad
            sy = torch.sum(s * y, dim=red)
            yy = torch.sum(y * y, dim=red)
            lr_bb = torch.clamp(
                torch.abs(sy) / torch.clamp(yy, min=1e-20),
                cfg.lr_min, cfg.lr_max,
            )
            lr = torch.where(accept, lr_bb, lr)
            scale = torch.where(accept, 1.0, scale * cfg.lr_shrink)
            scale = torch.clamp(scale, min=1e-8)
        else:
            lr = torch.where(accept, lr * cfg.lr_grow, lr * cfg.lr_shrink)
            lr = torch.clamp(lr, cfg.lr_min, cfg.lr_max)
        hist = torch.where(
            accept[:, None] & (slots[None, :] == ptr[:, None]),
            c2[:, None], hist,
        )
        ptr = torch.where(accept, (ptr + 1) % W, ptr)
        improved = c2 < best_c
        best_dp = torch.where(bshape(improved), cand, best_dp)
        best_c = torch.where(improved, c2, best_c)
        am = bshape(accept)
        dp = torch.where(am, cand, dp)
        grad = torch.where(am, g2, grad)
        n_acc = n_acc + accept.to(torch.int32)
        if record_trace:
            trace.append(best_c)
    if record_trace and trace:
        cost_trace = torch.stack(trace, dim=1)
    else:
        cost_trace = torch.full(
            (B, iters), float("nan"), dtype=dp.dtype, device=dp.device
        )
    return DescentResult(
        dp=best_dp, cost=best_c, n_accept=n_acc, cost_trace=cost_trace
    )
