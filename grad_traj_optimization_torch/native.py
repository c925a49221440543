"""ctypes bindings for the native host engine ``native/gtop_core.cpp``
(port of ``grad_traj_optimization_tpu.native``).

The C++ engine does the host-side work: the exact kinodynamic and hybrid
A* (``kino_search``, ``hybrid_search``), the free-end-velocity one-shot,
double-precision solves, a multithreaded EDT, the trilinear lookup and
the incremental RRT* tree (:class:`NativeRRTPlanner`).  The bindings,
argument types and the ``_cfg_arr`` layout are the JAX package's.

The library is built at first use from ``native/gtop_core.cpp`` with
``g++`` (the flags of ``native/Makefile``) into ``build/native/`` at the
repository root, which ``.gitignore`` lists.  The file name carries a
hash of the source, the flags and the host CPU (``-march=native`` code
runs only where it was built), so an edit or another machine rebuilds
it.  A lock keeps two threads from building at once; ``os.replace``
makes concurrent processes race safely.  A failed build raises with the
compiler's log: no stale library is kept, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from grad_traj_optimization_torch.search.rrt import RRTResult

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_REPO, "native", "gtop_core.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "native")
#: native/Makefile's flags (without its warnings)
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
             "-shared")
_ABI_VERSION = 6  # must match gtop_abi_version() in gtop_core.cpp

_LIB = None
_lock = threading.Lock()


def _cpu_id() -> str:
    """The host CPU's model and feature flags (what -march=native reads)."""
    keys = ("model name", "flags", "Features", "CPU part")
    try:
        with open("/proc/cpuinfo") as fh:
            lines = [ln for ln in fh if ln.split(":")[0].strip() in keys]
    except OSError:
        return ""
    return "".join(dict.fromkeys(lines))


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_id().encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libgtop_core-{h.hexdigest()[:16]}.so")


def compiler() -> str:
    """``$CXX`` or ``g++``, resolved on PATH; raises if absent."""
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if not cxx:
        raise RuntimeError(
            "no C++ compiler (CXX or g++ on PATH): the native host engine "
            "cannot be built on this host"
        )
    return cxx


def _compile(out_path: str) -> None:
    cxx = compiler()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    with open(out_path + ".log", "w") as fh:
        fh.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"native build failed ({proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out_path)


def load():
    """Build (once per source, flags and CPU) and load the engine."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not os.path.exists(path):
            _compile(path)
        lib = ctypes.CDLL(path)
        lib.gtop_abi_version.argtypes = []
        lib.gtop_abi_version.restype = ctypes.c_int
        abi = lib.gtop_abi_version()
        if abi != _ABI_VERSION:
            raise RuntimeError(
                f"{path}: ABI {abi} != expected {_ABI_VERSION}"
            )
        _declare(lib)
        _LIB = lib
        return lib


def _declare(lib) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.gtop_edt.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        f32p,
    ]
    lib.gtop_edt.restype = None
    lib.gtop_trilinear.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_float, f32p, ctypes.c_int, f32p, f32p,
    ]
    lib.gtop_trilinear.restype = None
    lib.gtop_solve.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_float, f64p, ctypes.c_int, f64p, f64p, f64p,
    ]
    lib.gtop_solve.restype = ctypes.c_double
    lib.gtop_solve_batch.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_float, f64p, ctypes.c_int, ctypes.c_int, f64p,
        f64p, f64p, f64p,
    ]
    lib.gtop_solve_batch.restype = None
    lib.gtop_rrt_create.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f64p,
        ctypes.c_double, f64p, f64p, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
    ]
    lib.gtop_rrt_create.restype = ctypes.c_void_p
    lib.gtop_rrt_destroy.argtypes = [ctypes.c_void_p]
    lib.gtop_rrt_destroy.restype = None
    lib.gtop_rrt_grow.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gtop_rrt_grow.restype = ctypes.c_int
    lib.gtop_rrt_best_cost.argtypes = [ctypes.c_void_p]
    lib.gtop_rrt_best_cost.restype = ctypes.c_double
    for name in ("gtop_rrt_commit_end", "gtop_rrt_n_nodes",
                 "gtop_rrt_path_len"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    lib.gtop_rrt_get_path.argtypes = [ctypes.c_void_p, f64p, f64p]
    lib.gtop_rrt_get_path.restype = None
    lib.gtop_rrt_reset_root.argtypes = [ctypes.c_void_p, f64p]
    lib.gtop_rrt_reset_root.restype = ctypes.c_int
    lib.gtop_rrt_update_map.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int,
    ]
    lib.gtop_rrt_update_map.restype = ctypes.c_int
    lib.gtop_rrt_root.argtypes = [ctypes.c_void_p, f64p, f64p]
    lib.gtop_rrt_root.restype = None
    lib.gtop_free_shot.argtypes = [
        f64p, f64p, f64p, ctypes.c_double, f64p, f64p, f64p,
    ]
    lib.gtop_free_shot.restype = None
    lib.gtop_hybrid_search.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_float, f64p, f64p, f64p, f64p, f64p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.gtop_hybrid_search.restype = ctypes.c_int
    lib.gtop_kino_search.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_float, f64p, f64p, f64p, f64p, f64p, ctypes.c_int,
    ]
    lib.gtop_kino_search.restype = ctypes.c_int


def available() -> bool:
    """Whether the engine builds and loads here (for the tests; no caller
    in the port uses it to skip work)."""
    try:
        load()
        return True
    except Exception:  # noqa: BLE001 — any build or load failure
        return False


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def edt(occ: np.ndarray, resolution: float) -> np.ndarray:
    """Multithreaded exact EDT (Felzenszwalb), float32 in/out."""
    lib = load()
    occ = np.ascontiguousarray(occ, dtype=np.float32)
    out = np.empty_like(occ)
    nx, ny, nz = occ.shape
    lib.gtop_edt(_f32p(occ), nx, ny, nz, resolution, _f32p(out))
    return out


def trilinear(dist, origin, resolution, queries):
    """Batched trilinear distance + gradient."""
    lib = load()
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    origin = np.ascontiguousarray(origin, dtype=np.float32)
    q = np.ascontiguousarray(queries, dtype=np.float32).reshape(-1, 3)
    n = len(q)
    d = np.empty(n, np.float32)
    g = np.empty((n, 3), np.float32)
    nx, ny, nz = dist.shape
    lib.gtop_trilinear(
        _f32p(dist), nx, ny, nz, _f32p(origin), resolution, _f32p(q), n,
        _f32p(d), _f32p(g),
    )
    return d, g


def _cfg_arr(cfg, steps):
    """The gtop_solve cfg array (ABI v5, 35 doubles)."""
    return np.array(
        [
            cfg.w_smooth, cfg.w_collision, cfg.alpha, cfg.d0, cfg.r,
            cfg.bos, cfg.vos, cfg.aos, cfg.mean_v, cfg.init_time,
            cfg.lr0, cfg.lr_grow, cfg.lr_shrink, cfg.lr_min, cfg.lr_max,
            cfg.n_samples, cfg.iters_step1, cfg.iters_step2, sum(steps),
            cfg.cost_eps, cfg.grad_eps, cfg.vel_eps, cfg.t_offset,
            1.0 if getattr(cfg, "step_rule", "adaptive") == "bb" else 0.0,
            float(getattr(cfg, "accept_window", 1)),
            {"reference": 0.0, "min_snap": 1.0, "dual": 2.0}[
                getattr(cfg, "seed_mode", "reference")
            ],
            float(getattr(cfg, "dual_ms_iters", 0)),
            cfg.alpha_v, cfg.v0, cfg.r_v, cfg.alpha_a, cfg.a0, cfg.r_a,
            float(getattr(cfg, "polish_iters", 0)),
            float(getattr(cfg, "dual_ms_window", 0)),
        ],
        dtype=np.float64,
    )


def solve(dist, origin, resolution, waypoints, cfg, steps=(2,)):
    """Deterministic double-precision solve, the algorithm of solver.py.

    Returns (coeff (m, 3, 6) float64, times (m,), cost).
    """
    lib = load()
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    origin32 = np.ascontiguousarray(origin, dtype=np.float32)
    wp = np.ascontiguousarray(waypoints, dtype=np.float64)
    n_wp = len(wp)
    m = n_wp - 1
    cfg_arr = _cfg_arr(cfg, steps)
    coeff = np.empty((m, 3, 6), np.float64)
    times = np.empty(m, np.float64)
    nx, ny, nz = dist.shape
    cost = lib.gtop_solve(
        _f32p(dist), nx, ny, nz, _f32p(origin32), resolution, _f64p(wp),
        n_wp, _f64p(cfg_arr), _f64p(coeff), _f64p(times),
    )
    return coeff, times, cost


def solve_batch(dist, origin, resolution, waypoints, cfg, steps=(2,)):
    """Threaded batched host solve: ``dist`` (B, nx, ny, nz) per scenario
    or (1, ...) / (nx, ny, nz) shared; ``waypoints`` (B, n_wp, 3).
    Returns (coeff (B, m, 3, 6) float64, times (B, m), costs (B,)),
    bitwise the per-case :func:`solve` calls."""
    lib = load()
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    if dist.ndim == 3:
        dist = dist[None]
    wp = np.ascontiguousarray(waypoints, dtype=np.float64)
    B, n_wp = wp.shape[0], wp.shape[1]
    n_grids = dist.shape[0]
    if n_grids not in (1, B):
        raise ValueError(f"dist batch {n_grids} != 1 or {B}")
    m = n_wp - 1
    origin32 = np.ascontiguousarray(origin, dtype=np.float32)
    cfg_arr = _cfg_arr(cfg, steps)
    coeff = np.empty((B, m, 3, 6), np.float64)
    times = np.empty((B, m), np.float64)
    costs = np.empty(B, np.float64)
    nx, ny, nz = dist.shape[1:]
    lib.gtop_solve_batch(
        _f32p(dist), n_grids, nx, ny, nz, _f32p(origin32), resolution,
        _f64p(wp), n_wp, B, _f64p(cfg_arr), _f64p(coeff), _f64p(times),
        _f64p(costs),
    )
    return coeff, times, costs


#: hybrid A* status codes (reference hybrid_astar.h:13-15)
HYBRID_NO_PATH = 0
HYBRID_REACH_END = 1
HYBRID_REACH_HORIZON = 2


def hybrid_search(
    dist,
    origin,
    resolution,
    start_state,
    goal_state,
    start_acc=(0.0, 0.0, 0.0),
    max_acc: float = 2.0,
    max_vel: float = 3.0,
    max_tau: float = 1.0,
    w_time: float = 10.0,
    lambda_heu: float = 5.0,
    horizon: float = 50.0,
    max_iters: int = 30000,
    init_max_tau: float = 0.8,
    use_init: bool = False,
    heu_mode: int = 0,
    margin: float = 0.2,
    max_knots: int = 64,
    shot_mode: int = 0,
):
    """Exact host-side hybrid A*, the compare2 front-end
    (HybridAStarPathFinder::searchPath, hybrid_astar.cpp:219-446, with the
    setParameterAuto defaults :17-23 and the 0.2 m clearance :644).

    Returns (pos (K,3), vel (K,3), acc (K,3), times (K-1,), status), status
    one of HYBRID_{NO_PATH, REACH_END, REACH_HORIZON}.
    """
    lib = load()
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    origin32 = np.ascontiguousarray(origin, dtype=np.float32)
    s9 = np.concatenate([
        np.asarray(start_state, np.float64).reshape(6),
        np.asarray(start_acc, np.float64).reshape(3),
    ])
    g6 = np.ascontiguousarray(goal_state, dtype=np.float64)
    cfg = np.array(
        [max_acc, max_vel, max_tau, w_time, lambda_heu, horizon,
         max_iters, init_max_tau, 1.0 if use_init else 0.0, heu_mode,
         margin, shot_mode],
        dtype=np.float64,
    )
    knots = np.zeros((max_knots, 9), np.float64)
    times = np.zeros(max_knots, np.float64)
    status = ctypes.c_int(0)
    nx, ny, nz = dist.shape
    k = lib.gtop_hybrid_search(
        _f32p(dist), nx, ny, nz, _f32p(origin32), resolution, _f64p(s9),
        _f64p(g6), _f64p(cfg), _f64p(knots), _f64p(times), max_knots,
        ctypes.byref(status),
    )
    if k == 0:
        return (np.zeros((0, 3)),) * 3 + (np.zeros(0), HYBRID_NO_PATH)
    return (
        knots[:k, 0:3], knots[:k, 3:6], knots[:k, 6:9], times[: k - 1],
        int(status.value),
    )


def kino_search(
    dist,
    origin,
    resolution,
    start_state,
    goal_state,
    max_acc: float = 2.0,
    max_vel: float = 3.0,
    max_tau: float = 0.5,
    w_time: float = 10.0,
    lambda_heu: float = 5.0,
    margin: float = 0.2,
    max_nodes: int = 20000,
    goal_r: float = 3.0,
    max_knots: int = 64,
):
    """Exact host-side kinodynamic A* (kinodynamic_astar.cpp:17-315).  It
    reads the float32 field and thresholds it in double
    (``dist <= margin``, gtop_core.cpp:939).

    Returns (pos (K,3), vel (K,3), acc (K,3), times (K-1,), reached).
    """
    lib = load()
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    origin32 = np.ascontiguousarray(origin, dtype=np.float32)
    s6 = np.ascontiguousarray(start_state, dtype=np.float64)
    g6 = np.ascontiguousarray(goal_state, dtype=np.float64)
    cfg = np.array(
        [max_acc, max_vel, max_tau, w_time, lambda_heu, margin,
         max_nodes, goal_r],
        dtype=np.float64,
    )
    knots = np.zeros((max_knots, 9), np.float64)
    times = np.zeros(max_knots, np.float64)
    nx, ny, nz = dist.shape
    k = lib.gtop_kino_search(
        _f32p(dist), nx, ny, nz, _f32p(origin32), resolution, _f64p(s6),
        _f64p(g6), _f64p(cfg), _f64p(knots), _f64p(times), max_knots,
    )
    if k == 0:
        return (np.zeros((0, 3)),) * 3 + (np.zeros(0), False)
    return (
        knots[:k, 0:3], knots[:k, 3:6], knots[:k, 6:9], times[: k - 1],
        True,
    )


def free_shot(p0, p1, v0, max_vel: float = 3.0):
    """Free-end-velocity minimum-acceleration cubic one-shot
    (getOptimalTime / getShotTrajectory, hybrid_astar.cpp:902-967).

    Returns (coef (3, 4) ascending powers, T, v1 (3,)).
    """
    lib = load()
    p0 = np.ascontiguousarray(p0, dtype=np.float64)
    p1 = np.ascontiguousarray(p1, dtype=np.float64)
    v0 = np.ascontiguousarray(v0, dtype=np.float64)
    coef = np.empty((3, 4), np.float64)
    T = np.empty(1, np.float64)
    v1 = np.empty(3, np.float64)
    lib.gtop_free_shot(
        _f64p(p0), _f64p(p1), _f64p(v0), float(max_vel), _f64p(coef),
        _f64p(T), _f64p(v1),
    )
    return coef, float(T[0]), v1


class NativeRRTPlanner:
    """Native incremental safe-ball informed RRT* (gtop_rrt_*), the C++
    engine for the reference's receding-horizon rrtPathFinder
    (path_finder.cpp: RRTpathFind :713-804, resetRoot/costRecast
    :302-375, RRTpathReEvaluate/ReConnect/treeRepair :1065-1554), with
    the method surface of :class:`search.rrt.RRTPlanner`, so
    ``replan.replan_loop_rrt`` can hold either.

    Its RNG (mt19937) differs from the NumPy planner's (PCG64): trees are
    behaviorally, not bitwise, comparable.
    """

    def __init__(self, dist_grid, origin, resolution, start, goal,
                 steer_len: float = 1.5, min_radius: float = 0.3,
                 goal_bias: float = 0.15, radius_margin: float | None = None,
                 seed: int = 0):
        self._lib = load()
        dist = np.ascontiguousarray(dist_grid, dtype=np.float32)
        self._shape = dist.shape
        self.goal = np.asarray(goal, dtype=np.float64).copy()
        self.min_radius = float(min_radius)
        o = np.ascontiguousarray(origin, dtype=np.float64)
        s = np.ascontiguousarray(start, dtype=np.float64)
        g = np.ascontiguousarray(self.goal)
        nx, ny, nz = dist.shape
        self._h = self._lib.gtop_rrt_create(
            _f32p(dist), nx, ny, nz, _f64p(o), float(resolution),
            _f64p(s), _f64p(g), float(steer_len), float(min_radius),
            float(goal_bias),
            -1.0 if radius_margin is None else float(radius_margin),
            int(seed),
        )

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.gtop_rrt_destroy(h)
            self._h = None

    @property
    def best_cost(self) -> float:
        return float(self._lib.gtop_rrt_best_cost(self._h))

    @property
    def commit_end(self) -> bool:
        return bool(self._lib.gtop_rrt_commit_end(self._h))

    def grow(self, n_iters: int) -> bool:
        return bool(self._lib.gtop_rrt_grow(self._h, int(n_iters)))

    def reset_root(self, commit_target) -> bool:
        t = np.ascontiguousarray(commit_target, dtype=np.float64)
        return bool(self._lib.gtop_rrt_reset_root(self._h, _f64p(t)))

    def update_map(self, dist_grid, repair_iters: int = 60) -> bool:
        dist = np.ascontiguousarray(dist_grid, dtype=np.float32)
        if dist.shape != self._shape:
            raise ValueError(
                f"update_map must keep the grid shape "
                f"({dist.shape} != {self._shape})"
            )
        return bool(
            self._lib.gtop_rrt_update_map(
                self._h, _f32p(dist), int(repair_iters)
            )
        )

    def result(self) -> RRTResult:
        k = int(self._lib.gtop_rrt_path_len(self._h))
        n_valid = int(self._lib.gtop_rrt_n_nodes(self._h))
        if k == 0:
            # as rrt.RRTPlanner.result(): the unreached case is a 1-point
            # path at the current root
            c = np.zeros(3, np.float64)
            r = np.zeros(1, np.float64)
            self._lib.gtop_rrt_root(self._h, _f64p(c), _f64p(r))
            return RRTResult(
                path=c[None], radii=r.copy(),
                reached=False, cost=np.inf, n_nodes=n_valid,
            )
        path = np.zeros((k, 3), np.float64)
        radii = np.zeros(k, np.float64)
        self._lib.gtop_rrt_get_path(self._h, _f64p(path), _f64p(radii))
        return RRTResult(
            path=path, radii=radii, reached=True,
            cost=self.best_cost, n_nodes=n_valid,
        )
