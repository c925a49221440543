"""Published peaks of one NVIDIA H100 SXM (NVIDIA data sheet, at its
700 W limit) and the least time the card could take for each layer's
work, the larger of its operations over the float32 peak and its bytes
over the memory bandwidth.  A share of a roofline is that least time over
the measured device time, so it cannot pass 100% unless the work is
counted too high or the time leaves part of it out."""

from __future__ import annotations

#: HBM3 bytes a second, and float32 operations a second outside the
#: tensor cores
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12


def edt_bound_ms(n_cells: int, occ_bytes: int = 4, field_bytes: int = 4):
    """EDT of ``n_cells`` cells: the occupancy read once and the field
    written once; the passes' own traffic in between is the program's
    choice and is not counted."""
    return {"ops_ms": 0.0,
            "bytes_ms": n_cells * (occ_bytes + field_bytes) / HBM_BPS * 1e3}


def k3_bound_ms(B, m, K, evals, use_a):
    """The whole descent of ``B`` lanes of ``m`` segments, ``K`` samples a
    segment and ``evals`` cost evaluations: float32 operations of the
    compact form per sample and evaluation (position and velocity chains
    6 x 3 x 2 FMAs = 72, the gradient partials 72, the trilinear lookup
    ~70, the collision terms ~20; with the acceleration chain and the
    penalties 112 more), Rpp @ x and the BB update per lane; bytes of the
    inputs read once (the compact chains, dt, Rpp, the bounds, the seed,
    Df, misc and the eight grid corners of every sample) and of the
    outputs written once."""
    S, P = m * K, 3 * m - 3
    per_sample = 72 + 72 + 70 + 20 + (112 if use_a else 0)
    flops = B * evals * (S * per_sample + 2 * 3 * P * P + 8 * 3 * P)
    chains = 3 if use_a else 2
    nbytes = B * (4 * (S * (6 * chains + 1) + P * P + 4 * 3 * P + 18 + 16)
                  + 32 * S + 4 * (3 * P + 2 + evals))
    return {"ops_ms": flops / FP32_FLOPS * 1e3,
            "bytes_ms": nbytes / HBM_BPS * 1e3}


def bound_ms(b: dict) -> float:
    return max(b["ops_ms"], b["bytes_ms"])


def share(bound: float, device_ms: float):
    """Percent of the roofline, or None where no device time was read."""
    if not device_ms or device_ms <= 0:
        return None
    return 100.0 * bound / device_ms
