"""Plain reference of the trajectory refinement, in any float dtype.

A frozen, self-contained copy of the arithmetic of the upstream optimizer
(grad_traj_optimizer.cpp:35-448, qp_generator.cpp:23-451): piecewise
quintics over endpoint derivatives, the snap form, the collision line
integral sampled at ``t_offset + k T / n_samples`` with the reference's
gradient quirks, box bounds, and the projected Barzilai-Borwein descent
with its acceptance rule.  It imports nothing of the program under test.

Every function takes batched tensors (a leading lane axis).  ``prec``
selects the arithmetic: ``"f64"`` is the reference; ``"tf32"`` is the
control, float32 with the inputs of every contraction and the stored
field rounded to TF32's 10-bit mantissa, as TF32 tensor cores round them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties away) at TF32's 10 mantissa
    bits; other dtypes pass through."""
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Prec:
    dtype: torch.dtype
    tf32: bool

    def mm(self, eq, *ops):
        if self.tf32:
            ops = tuple(tf32_round(o) for o in ops)
        return torch.einsum(eq, *ops)

    def store(self, x):
        return tf32_round(x) if self.tf32 else x


PRECS = {"f64": Prec(torch.float64, False), "tf32": Prec(torch.float32, True)}


# ---- quintic segments -------------------------------------------------

DERIV_ORD = np.array([0, 0, 1, 1, 2, 2], dtype=np.int64)


def _unit_hermite():
    a = np.zeros((6, 6))
    fact = [1, 1, 2, 6, 24, 120]
    for i in range(3):
        a[2 * i, i] = fact[i]
        for j in range(i, 6):
            a[2 * i + 1, j] = fact[j] / fact[j - i]
    return a


def _unit_snap():
    q = np.zeros((6, 6))
    for i in range(3, 6):
        for j in range(3, 6):
            q[i, j] = i * (i - 1) * (i - 2) * j * (j - 1) * (j - 2) / (i + j - 5)
    return q


A1INV = np.linalg.inv(_unit_hermite())
KSNAP = A1INV.T @ _unit_snap() @ A1INV


def segment_ainv(T):
    """(..., m) -> (..., m, 6, 6): coefficients = Ainv @ (p0 p1 v0 v1 a0 a1)."""
    ordv = torch.as_tensor(DERIV_ORD, dtype=T.dtype, device=T.device)
    j = torch.arange(6, dtype=T.dtype, device=T.device)
    a1 = torch.as_tensor(A1INV, dtype=T.dtype, device=T.device)
    return a1 * T[..., None, None] ** (ordv[None, :] - j[:, None])


def segment_snap(T):
    ordv = torch.as_tensor(DERIV_ORD, dtype=T.dtype, device=T.device)
    ks = torch.as_tensor(KSNAP, dtype=T.dtype, device=T.device)
    return ks * T[..., None, None] ** (ordv[:, None] + ordv[None, :] - 5.0)


def powers(t, deriv):
    j = torch.arange(6, dtype=t.dtype, device=t.device)
    if deriv == 0:
        return t[..., None] ** j
    if deriv == 1:
        tp = torch.cat([torch.zeros_like(t[..., None]), t[..., None] ** j[:5]], -1)
        return j * tp
    raise ValueError(deriv)


@functools.lru_cache(maxsize=None)
def dmap(m: int) -> np.ndarray:
    """Slot 6s + 2i + e (segment s, order i, end e) -> index into
    d = [p0 v0 a0, pm vm am, (p v a) of interior knots 1..m-1]."""
    idx = np.zeros(6 * m, dtype=np.int64)
    for s in range(m):
        for i in range(3):
            for e in range(2):
                w = s + e
                idx[6 * s + 2 * i + e] = (i if w == 0 else 3 + i if w == m
                                          else 6 + 3 * (w - 1) + i)
    return idx


def selection(m: int, like):
    ct = np.zeros((6 * m, 3 * m + 3))
    ct[np.arange(6 * m), dmap(m)] = 1.0
    return torch.as_tensor(ct, dtype=like.dtype, device=like.device).reshape(
        m, 6, 3 * m + 3)


def fixed_and_free(starts, ends, pos, vel, acc):
    """Df (B, 3, 6) = [p0 v0 a0 pm vm am]; dp (B, 3, 3m-3) of the interior
    knots' (p, v, a), axis-major."""
    Df = torch.stack([starts[0], starts[1], starts[2],
                      ends[0], ends[1], ends[2]], dim=-1)
    inner = torch.stack([pos, vel, acc], dim=-1)  # (B, m-1, 3, 3)
    B, n = inner.shape[:2]
    return Df, inner.transpose(1, 2).reshape(B, 3, 3 * n)


def straight_seed(wp, cfg):
    """Reference seed from waypoints (B, m+1, 3): segment times, Df and dp."""
    t = torch.linalg.norm(wp[:, 1:] - wp[:, :-1], dim=-1) / cfg["mean_v"]
    T = torch.cat([t[:, :1] + cfg["init_time"], t[:, 1:]], dim=1)
    z = torch.zeros_like(wp[:, 0])
    inner = wp[:, 1:-1]
    Df, dp = fixed_and_free((wp[:, 0], z, z), (wp[:, -1], z, z), inner,
                            torch.zeros_like(inner), torch.zeros_like(inner))
    return T, Df, dp


def knot_seed(pos, vel, acc):
    """setKinoPath seed from knot states (B, m+1, 3): Df and dp."""
    return fixed_and_free((pos[:, 0], vel[:, 0], acc[:, 0]),
                          (pos[:, -1], vel[:, -1], acc[:, -1]),
                          pos[:, 1:-1], vel[:, 1:-1], acc[:, 1:-1])


def stack_d(Df, dp, m):
    d = torch.cat([Df, dp], dim=-1)
    return d[..., torch.as_tensor(dmap(m), device=d.device)]


def coefficients(Df, dp, T, prec: Prec):
    """(B, m, 3, 6) ascending-power coefficients."""
    m = T.shape[-1]
    D = stack_d(Df, dp, m).reshape(*Df.shape[:-1], m, 6)
    return prec.mm("bsjk,bxsk->bsxj", segment_ainv(T), D)


def endpoints(coeff, T):
    """Start and end positions (B, 3) of (B, m, 3, 6) coefficients."""
    tp = T[:, -1:, None] ** torch.arange(6, dtype=T.dtype, device=T.device)
    return coeff[:, 0, :, 0], torch.sum(coeff[:, -1] * tp, dim=-1)


def position_at(coeff, T, t):
    """Positions (B, 3) of (B, m, 3, 6) coefficients at times t (B,) from
    the trajectory's start, clamped into it."""
    ends = torch.cumsum(T, dim=1)
    j = torch.clamp(torch.sum(ends <= t[:, None], dim=1), max=T.shape[1] - 1)
    lanes = torch.arange(T.shape[0], device=T.device)
    tau = torch.clamp(t - (ends[lanes, j] - T[lanes, j]), min=0.0)
    tau = torch.minimum(tau, T[lanes, j])
    tp = tau[:, None] ** torch.arange(6, dtype=T.dtype, device=T.device)
    return torch.sum(coeff[lanes, j] * tp[:, None], dim=-1)


# ---- the problem and its cost ------------------------------------------

@dataclasses.dataclass
class Problem:
    T: torch.Tensor
    Df: torch.Tensor
    R: torch.Tensor
    Rfp: torch.Tensor
    Rpp: torch.Tensor
    H: torch.Tensor      # (B, m, K, 6) position Hermite basis
    HV: torch.Tensor
    TL: torch.Tensor     # (B, m, K, P) position chain of dp
    TVL: torch.Tensor
    dt: torch.Tensor     # (B, m)
    lb: torch.Tensor
    ub: torch.Tensor
    field: torch.Tensor  # (B or 1, nx, ny, nz)
    origin: torch.Tensor  # (3,)
    res: float
    cfg: dict
    prec: Prec


def check_config(cfg: dict) -> None:
    """The reference covers the active schedule only; raise elsewhere."""
    want = dict(alpha_v=0.0, alpha_a=0.0, step_rule="bb",
                seed_mode="reference", gradient_mode="reference")
    for k, v in want.items():
        if cfg[k] != v:
            raise ValueError(f"reference covers {k}={v!r}, got {cfg[k]!r}")


def problem(T, Df, dp0, field, origin, res, cfg, prec: Prec):
    """Bases, chains and bounds of a batch; the position bounds are centred
    on the seed ``dp0``'s position slots, the interior knots."""
    check_config(cfg)
    dt_ = prec.dtype
    T, Df, dp0 = T.to(dt_), Df.to(dt_), dp0.to(dt_)
    B, m = T.shape
    ct = selection(m, T)
    ainv = segment_ainv(T)
    L = prec.mm("bsjk,ska->bsja", ainv, ct)  # (B, m, 6, ndim)
    R = prec.mm("spa,nspq,sqc->nac", ct, segment_snap(T), ct)
    K = cfg["n_samples"]
    k = torch.arange(K, dtype=dt_, device=T.device)
    ts = cfg["t_offset"] + k * (T[..., None] / K)
    Tm, TVm = powers(ts, 0), powers(ts, 1)
    H = prec.mm("bmkj,bmjd->bmkd", Tm, ainv)
    HV = prec.mm("bmkj,bmjd->bmkd", TVm, ainv)
    Ldp = L[..., 6:]
    TL = prec.mm("bmkj,bmjd->bmkd", Tm, Ldp)
    TVL = prec.mm("bmkj,bmjd->bmkd", TVm, Ldp)
    P = dp0.shape[-1]
    slot = torch.arange(P, device=T.device) % 3
    half = torch.tensor([cfg["bos"], cfg["vos"], cfg["aos"]], dtype=dt_,
                        device=T.device)[slot]
    c = torch.where(slot == 0, dp0, torch.zeros_like(dp0))
    return Problem(T=T, Df=Df, R=R, Rfp=R[:, :6, 6:], Rpp=R[:, 6:, 6:], H=H,
                   HV=HV, TL=TL, TVL=TVL, dt=T / K, lb=c - half, ub=c + half,
                   field=prec.store(field.to(dt_)), origin=origin.to(dt_),
                   res=float(res), cfg=cfg, prec=prec)


def trilinear(field, origin, res, pos):
    """Distance and gradient at pos (B, S, 3) in field (B or 1, nx, ny, nz);
    the upstream SDFMap lookup: -1 and 0 outside the map (1e-4 margin)."""
    B, S, _ = pos.shape
    nx, ny, nz = field.shape[1:]
    n = torch.tensor([nx, ny, nz], dtype=pos.dtype, device=pos.device)
    ok = torch.all((pos > origin + 1e-4) & (pos < origin + n * res - 1e-4), -1)
    idx = torch.floor((pos - 0.5 * res - origin) / res).to(torch.int64)
    diff = (pos - ((idx.to(pos.dtype) + 0.5) * res + origin)) / res
    flat = field.reshape(field.shape[0], -1)
    lane = torch.arange(B, device=pos.device)[:, None] if field.shape[0] > 1 \
        else torch.zeros((B, 1), dtype=torch.int64, device=pos.device)
    cx = [idx[..., 0].clamp(0, nx - 1), (idx[..., 0] + 1).clamp(0, nx - 1)]
    cy = [idx[..., 1].clamp(0, ny - 1), (idx[..., 1] + 1).clamp(0, ny - 1)]
    cz = [idx[..., 2].clamp(0, nz - 1), (idx[..., 2] + 1).clamp(0, nz - 1)]
    v = [[[flat[lane, (cx[a] * ny + cy[b]) * nz + cz[c]] for c in (0, 1)]
          for b in (0, 1)] for a in (0, 1)]
    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
    v00 = (1 - dx) * v[0][0][0] + dx * v[1][0][0]
    v01 = (1 - dx) * v[0][0][1] + dx * v[1][0][1]
    v10 = (1 - dx) * v[0][1][0] + dx * v[1][1][0]
    v11 = (1 - dx) * v[0][1][1] + dx * v[1][1][1]
    v0 = (1 - dy) * v00 + dy * v10
    v1 = (1 - dy) * v01 + dy * v11
    d = (1 - dz) * v0 + dz * v1
    gz = (v1 - v0) / res
    gy = ((1 - dz) * (v10 - v00) + dz * (v11 - v01)) / res
    gx = ((1 - dz) * (1 - dy) * (v[1][0][0] - v[0][0][0])
          + (1 - dz) * dy * (v[1][1][0] - v[0][1][0])
          + dz * (1 - dy) * (v[1][0][1] - v[0][0][1])
          + dz * dy * (v[1][1][1] - v[0][1][1])) / res
    g = torch.stack([gx, gy, gz], dim=-1)
    return torch.where(ok, d, -1.0), torch.where(ok[..., None], g, 0.0)


def cost_and_grad(pb: Problem, dp, with_grad=True):
    """Step-2 cost (B,) and gradient (B, 3, P) at dp (B, 3, P)."""
    cfg, mm = pb.cfg, pb.prec.mm
    B, m = pb.T.shape
    K = cfg["n_samples"]
    d = torch.cat([pb.Df, dp], dim=-1)
    cost_s = mm("nxa,nac,nxc->n", d, pb.R, d)
    grad_s = 2.0 * mm("bxf,bfd->bxd", pb.Df, pb.Rfp) \
        + 2.0 * mm("bxp,bpd->bxd", dp, pb.Rpp)
    ws, wc = cfg["w_smooth"], cfg["w_collision"]
    if abs(wc) < 1e-4:
        return ws * cost_s + cfg["cost_eps"], ws * grad_s + cfg["grad_eps"]
    d6 = stack_d(pb.Df, dp, m).reshape(B, 3, m, 6)
    pos = mm("bmkj,bxmj->bmkx", pb.H, d6)
    vel = mm("bmkj,bxmj->bmkx", pb.HV, d6)
    dist, g = trilinear(pb.field, pb.origin, pb.res, pos.reshape(B, m * K, 3))
    dist, g = dist.reshape(B, m, K), g.reshape(B, m, K, 3)
    cd = cfg["alpha"] * torch.exp(-(dist - cfg["d0"]) / cfg["r"])
    gd = -cd / cfg["r"]
    vn = torch.linalg.norm(vel, dim=-1) + cfg["vel_eps"]
    cost = ws * cost_s + wc * torch.sum(cd * vn * pb.dt[..., None], dim=(1, 2)) \
        + cfg["cost_eps"]
    if not with_grad:
        return cost, None
    w1 = (gd * cd * vn)[..., None] * g
    w2 = (cd / vn)[..., None] * vel
    grad_c = mm("bmkx,bmkd,bm->bxd", w1, pb.TL, pb.dt) \
        + mm("bmkx,bmkd,bm->bxd", w2, pb.TVL, pb.dt)
    return cost, ws * grad_s + wc * grad_c + cfg["grad_eps"]


def descend(pb: Problem, dp0, iters: int):
    """Projected BB descent (the upstream schedule, acceptance against the
    window's worst cost).  Returns (best dp, best cost, cost envelope
    (B, iters))."""
    cfg = pb.cfg
    dp = torch.clamp(dp0.to(pb.prec.dtype), pb.lb, pb.ub)
    B = dp.shape[0]
    W = cfg["accept_window"]
    c0, grad = cost_and_grad(pb, dp)
    lr = cfg["lr0"] / (torch.sqrt(torch.sum(grad * grad, dim=(1, 2))) + 1e-12)
    scale = torch.ones_like(lr)
    hist = c0[:, None].expand(B, W).clone()
    ptr = torch.zeros((B,), dtype=torch.int64, device=dp.device)
    slots = torch.arange(W, device=dp.device)
    best_c, best_dp, trace = c0, dp, []
    for _ in range(iters):
        cand = torch.clamp(dp - (lr * scale)[:, None, None] * grad, pb.lb, pb.ub)
        c2, g2 = cost_and_grad(pb, cand)
        accept = c2 < torch.amax(hist, dim=1)
        s, y = cand - dp, g2 - grad
        sy = torch.sum(s * y, dim=(1, 2))
        yy = torch.sum(y * y, dim=(1, 2))
        lr_bb = torch.clamp(torch.abs(sy) / torch.clamp(yy, min=1e-20),
                            cfg["lr_min"], cfg["lr_max"])
        lr = torch.where(accept, lr_bb, lr)
        scale = torch.clamp(torch.where(accept, 1.0, scale * cfg["lr_shrink"]),
                            min=1e-8)
        hist = torch.where(accept[:, None] & (slots[None] == ptr[:, None]),
                           c2[:, None], hist)
        ptr = torch.where(accept, (ptr + 1) % W, ptr)
        better = c2 < best_c
        best_dp = torch.where(better[:, None, None], cand, best_dp)
        best_c = torch.where(better, c2, best_c)
        dp = torch.where(accept[:, None, None], cand, dp)
        grad = torch.where(accept[:, None, None], g2, grad)
        trace.append(best_c)
    return best_dp, best_c, torch.stack(trace, dim=1)


# ---- search knots -> back-end knots --------------------------------------

def _linspace(start, stop, n):
    s = torch.arange(n - 1, dtype=start.dtype, device=start.device) / float(n - 1)
    out = start[:, None] * (1 - s) + stop[:, None] * s
    return torch.cat([out, stop[:, None]], dim=1)


def resample_knots(pos, vel, times, n: int):
    """``n`` knot states a lane from a search branch (B, K+1, 3) with
    segment durations (B, K): cubic Hermite between bracketing knots; long
    branches snap to whole knots, short ones take uniform time; zero-length
    prefix segments collapse onto t = 0.  Returns pos, vel, acc (B, n, 3)
    and segment times (B, n-1)."""
    B, K = times.shape
    cts = [torch.zeros_like(times[:, 0])]
    for i in range(K):
        cts.append(cts[-1] + times[:, i])
    ct = torch.stack(cts, dim=1)
    r = torch.sum(times > 1e-9, dim=1)
    ones = torch.ones_like(ct[:, 0])
    fi = torch.round(_linspace(0 * ones, ones, n) * r.to(ct.dtype)[:, None])
    kidx = torch.clamp((K - r)[:, None] + fi.long(), 0, K)
    t_knots = torch.gather(ct, 1, kidx)
    t_unif = _linspace(0 * ct[:, -1], ct[:, -1], n)
    targets = torch.where((r >= n - 1)[:, None], t_knots, t_unif)
    j = torch.clamp(torch.sum(ct[:, None, :] <= targets[:, :, None] + 1e-9,
                              dim=2) - 1, 0, K - 1)
    Tj = torch.clamp(torch.gather(times, 1, j), min=1e-9)
    s = torch.clamp((targets - torch.gather(ct, 1, j)) / Tj, 0.0, 1.0)[..., None]
    Tj = Tj[..., None]
    j3 = j[..., None].expand(-1, -1, 3)
    p0, p1 = torch.gather(pos, 1, j3), torch.gather(pos, 1, j3 + 1)
    v0, v1 = torch.gather(vel, 1, j3) * Tj, torch.gather(vel, 1, j3 + 1) * Tj
    s2 = s * s
    s3 = s * s2
    pk = ((2 * s3 - 3 * s2 + 1) * p0 + (s3 - 2 * s2 + s) * v0
          + (-2 * s3 + 3 * s2) * p1 + (s3 - s2) * v1)
    d00 = 6 * s2 - 6 * s
    vk = (d00 * p0 + (3 * s2 - 4 * s + 1) * v0 - d00 * p1
          + (3 * s2 - 2 * s) * v1) / Tj
    g00 = 12 * s - 6
    ak = (g00 * p0 + (6 * s - 4) * v0 - g00 * p1 + (6 * s - 2) * v1) / (Tj * Tj)
    seg = torch.clamp(targets[:, 1:] - targets[:, :-1], min=1e-2)
    return pk, vk, ak, seg
