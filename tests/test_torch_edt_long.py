"""K1's long-line kernel (``gto_minplus_long`` in csrc/minplus.cu) as a
numpy mirror, held bit for bit against the plain version and the JAX
package's dense pass on the CPU.

The kernel runs only on a GPU (tests/test_torch_cuda.py and
chip_smoke.py hold it against its plain version there).  Its design rests
on an arithmetic argument: on a line whose values below 2^24 are
non-negative integers, the exact lower envelope of the sources below 2^24,
in integer arithmetic, gives the plain two-rounding result wherever it
lies below 2^24, and every other output takes the two-rounding evaluation
over a window.  ``_kernel_line`` repeats the kernel's steps one for one
(the staging flags, the 256 band envelopes with their clamped integer
thresholds and the sources their neighbours beat everywhere left out,
the eight merge levels, the walk over the merged envelope,
the window of the two-rounding evaluation and the line-minimum rule), so
the adversarial lines below test the argument and the algorithm without a
card.
"""

import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from grad_traj_optimization_tpu.fields import sdf as jsdf  # noqa: E402

from grad_traj_optimization_torch import fixtures  # noqa: E402
from grad_traj_optimization_torch.ops import edt_cuda  # noqa: E402

BANDS = 256           # csrc/minplus.cu kLT: threads a block, bands a line
EXACT = 1 << 24       # kExact
NO_Z = -(1 << 31)     # kNoZ


def _ceil_clamped(N, D, n):
    """ceil(N / D) clamped to [0, n]: the kernel corrects its float
    estimate of the quotient with exact integer steps, so it gives the
    exact value that Python's integers give here."""
    if N <= 0:
        return 0
    if N > n * D:
        return n
    return -(-N // D)


def _scan(F, q, lo, hi):
    """min over v in [lo, hi] of fl(fl(d^2) + F[v]), d = q - v."""
    d = (q - np.arange(lo, hi + 1)).astype(np.float32)
    return (d * d + F[lo:hi + 1]).min()


def _dense(F, q, U, every):
    """The two-rounding evaluation: every v on a line with a negative
    value or NaN; else the nearest 33 cells lower U, and only the window
    d^2 < U can go below it."""
    n = F.shape[0]
    if every:
        return _scan(F, q, 0, n - 1)
    U = min(U, _scan(F, q, max(0, q - 16), min(n - 1, q + 16)))
    if not U < np.float32(1.0e14):
        return min(U, _scan(F, q, 0, n - 1))
    r = int(min(float(n), math.floor(math.sqrt(float(U))) + 1.0))
    return min(U, _scan(F, q, max(0, q - r), min(n - 1, q + r)))


def _merge(st, SV, SZ, key, s, n, a0, m):
    """long_merge: group B (from band m) pushed onto group A (from a0)."""
    lo, hi, zf, prv, nxt, gf, gl = st
    la, fb = gl[a0], gf[m]
    if la < 0:
        gf[a0], gl[a0] = gf[m], gl[m]
        return
    if fb < 0:
        return
    glb = gl[m]
    ta, ja = la, hi[la]
    hb, jb = fb, lo[fb]
    while True:
        vc = hb * s + SV[hb * s + jb]
        while True:
            vt = ta * s + SV[ta * s + ja]
            N, D = key(vc) - key(vt), 2 * (vc - vt)
            zt = zf[ta] if ja == lo[ta] else SZ[ta * s + ja]
            if zt == NO_Z or (zt < n and N > zt * D):
                break
            if ja > lo[ta]:
                ja -= 1
            else:
                hi[ta] = lo[ta] - 1
                ta = prv[ta]
                ja = hi[ta]
        zc = _ceil_clamped(N, D, n)
        zn = math.inf
        if jb < hi[hb]:
            zn = SZ[hb * s + jb + 1]
        elif hb != glb:
            zn = zf[nxt[hb]]
        if zn > zc:
            break
        if jb < hi[hb]:
            jb += 1
        else:
            hi[hb] = lo[hb] - 1
            hb = nxt[hb]
            jb = lo[hb]
    hi[ta], lo[hb], zf[hb] = ja, jb, zc
    prv[hb], nxt[ta], gl[a0] = ta, hb, glb


def _kernel_line(F):
    """One block's work on one line: (out, integer line?, integer-path
    output mask)."""
    F = np.asarray(F, np.float32)
    n = F.shape[0]
    with np.errstate(invalid="ignore"):
        other = bool(np.any(~((F >= EXACT) | ((F >= 0) & (F == np.floor(F))))))
        every = bool(np.any(~(F >= 0)))
    fmin = None if every else (F + np.float32(0)).min()
    out = np.empty(n, np.float32)
    on_int = np.zeros(n, bool)
    if other:  # every output on the two-rounding path
        for q in range(n):
            if not every and F[q] <= fmin:
                out[q] = np.float32(0) + F[q]
            else:
                out[q] = _dense(F, q, F[q], every)
        return out, False, on_int

    s = -(-n // BANDS)

    def key(v):
        return int(F[v]) + v * v

    SV = np.zeros(n, np.int64)
    SZ = np.zeros(n, np.int64)
    cnt = []
    def needed(v):  # not beaten at every output by two source neighbours
        if not (0 < v < n - 1 and F[v - 1] < EXACT and F[v + 1] < EXACT):
            return True
        a = -(-(key(v + 1) - key(v)) // 2)
        b = -(-(key(v) - key(v - 1)) // 2)
        return min(max(a, 0), n) > min(max(b, 0), n)

    for b in range(BANDS):  # band envelopes
        v0, c = b * s, 0
        for v in range(v0, min(n, v0 + s)):
            if not F[v] < EXACT or not needed(v):
                continue
            z = NO_Z
            while c > 0:
                vt = v0 + SV[v0 + c - 1]
                N, D = key(v) - key(vt), 2 * (v - vt)
                zt = NO_Z if c == 1 else SZ[v0 + c - 1]
                if zt != NO_Z and (zt >= n or N <= zt * D):
                    c -= 1
                    continue
                z = _ceil_clamped(N, D, n)
                break
            SV[v0 + c], SZ[v0 + c] = v - v0, z
            c += 1
        cnt.append(c)
    st = ([0] * BANDS, [c - 1 for c in cnt], [NO_Z] * BANDS,
          [-1] * BANDS, [-1] * BANDS,
          [b if cnt[b] else -1 for b in range(BANDS)],
          [b if cnt[b] else -1 for b in range(BANDS)])
    w = 1
    while w < BANDS:  # the merge levels
        for a0 in range(0, BANDS, 2 * w):
            _merge(st, SV, SZ, key, s, n, a0, a0 + w)
        w *= 2
    lo, hi, zf = st[:3]
    nb = [b for b in range(BANDS) if hi[b] >= lo[b]]
    nz = [zf[b] for b in nb]
    m = len(nb)
    for t in range(BANDS):  # each band's outputs
        q0, q1 = t * s, min(n, t * s + s)
        if q0 >= n:
            continue
        if m:
            k = max(i for i in range(m) if nz[i] <= q0)
            b = nb[k]
            j = lo[b]
            while j < hi[b] and SZ[b * s + j + 1] <= q0:
                j += 1
        for q in range(q0, q1):
            if m:
                while True:
                    zn = (SZ[b * s + j + 1] if j < hi[b]
                          else nz[k + 1] if k + 1 < m else math.inf)
                    if zn > q:
                        break
                    if j < hi[b]:
                        j += 1
                    else:
                        k += 1
                        b, j = nb[k], lo[nb[k]]
                ve = b * s + SV[b * s + j]
                H = int(F[ve]) + (q - ve) ** 2
                if H < EXACT:
                    out[q] = np.float32(H)
                    on_int[q] = True
                    continue
            if F[q] <= fmin:
                out[q] = np.float32(0) + F[q]
                continue
            U = F[q]
            if m:
                d = np.float32(q - ve)
                U = min(U, d * d + F[ve])
            out[q] = _dense(F, q, U, False)
    return out, True, on_int


def _exact_h(f):
    """min over the sources below 2^24 of (q - v)^2 + f_v, in int64 (a
    huge value where there is none)."""
    n = f.shape[0]
    src = np.nonzero(f < EXACT)[0]
    fv = f[src].astype(np.int64)
    h = np.full(n, np.iinfo(np.int64).max, np.int64)
    for q0 in range(0, n, 512):
        q = np.arange(q0, min(n, q0 + 512))
        if src.size:
            h[q] = ((q[:, None] - src[None, :]) ** 2 + fv[None, :]).min(1)
    return h


def test_bands_constant_matches_the_kernel():
    path = os.path.join(os.path.dirname(edt_cuda.__file__), os.pardir,
                        "csrc", "minplus.cu")
    with open(path) as fh:
        src = fh.read()
    assert re.search(r"constexpr int kLT = (\d+);", src).group(1) == \
        str(BANDS)
    assert "constexpr float kExact = 16777216.0f;" in src


@pytest.mark.parametrize("n", [4097, 5000, 6000])
def test_long_kernel_mirror_bitwise(n):
    """The mirror of gto_minplus_long, bitwise the plain version and the
    JAX package's dense pass on adversarial lines; each line takes the
    path it should, and an integer line's two-rounding outputs are
    exactly those whose exact envelope value reaches 2^24."""
    f, kinds = fixtures.long_line_cases(n)
    want = edt_cuda.minplus_lines_plain(torch.as_tensor(f)).numpy()
    ref = np.asarray(jsdf._minplus_parabola_lines(jnp.asarray(f)))
    np.testing.assert_array_equal(want.view(np.int32), ref.view(np.int32))
    on = []
    for i, (line, kind) in enumerate(zip(f, kinds)):
        got, integer, on_int = _kernel_line(line)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want[i].view(np.int32),
                                      err_msg=f"line {i} ({kind})")
        assert integer == (kind == "int"), i
        if integer:
            np.testing.assert_array_equal(on_int, _exact_h(line) < EXACT)
        on.append(on_int)
    # both paths are reached where the argument says
    assert on[4][:4096].all() and not on[4][4096:].any()  # the lone source
    assert not on[3].any()  # every cell BIG_CELLS^2
    assert all(o.all() for o in on[6:10])  # the occupancy grid's lines
