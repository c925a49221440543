"""Visualization & export — host-side replacement for the rviz pipeline
(port of ``grad_traj_optimization_tpu.viz``).

The reference visualizes through ROS markers (include/.../display.h:
visualizeSetPoints/displayTrajectory; sdf_map.cpp:122-153 occupancy
markers, :370-421 layered ESDF with distance-level transparency).  Here
the observables are files: compressed npz scene dumps and optional
matplotlib figures — consumable without a ROS stack.  Tensors are
downloaded from their device; matplotlib is imported by the plot
functions only, so :func:`scene_arrays` and :func:`export_npz` need none.
"""

from __future__ import annotations

import numpy as np
import torch

from grad_traj_optimization_torch.core import poly


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scene_arrays(sol, scenario=None, n_samples: int = 400):
    """Collect plottable arrays from a Solution (+ optional Scenario)."""
    pos, ts = poly.sample_uniform(sol.coeff, sol.T, n_samples)
    vel, _ = poly.sample_uniform(sol.coeff, sol.T, n_samples, deriv=1)
    out = {
        "traj": _host(pos),
        "vel": _host(vel),
        "t": _host(ts),
        "segment_times": _host(sol.T),
        "coeff": _host(sol.coeff),
        "cost_trace": _host(sol.cost_trace),
    }
    if scenario is not None:
        out["waypoints"] = _host(scenario.waypoints)
        out["origin"] = _host(scenario.origin)
        out["resolution"] = _host(scenario.resolution)
        dist = _host(scenario.dist)
        out["occupied"] = np.stack(np.nonzero(dist == 0.0), axis=-1)
        out["dist_slice_mid_z"] = dist[:, :, dist.shape[2] // 2]
    return out


def export_npz(path: str, sol, scenario=None, n_samples: int = 400):
    """Dump a solved scene to a compressed npz (the 'rviz topic')."""
    np.savez_compressed(path, **scene_arrays(sol, scenario, n_samples))
    return path


def plot_topdown(sol, scenario, ax=None, n_samples: int = 400):
    """Top-down (x, y) plot: occupancy, waypoints, optimized trajectory.

    Equivalent of the reference's displayPathWithColor triplet
    (opti_node.cpp:128-134).  Requires matplotlib.
    """
    import matplotlib.pyplot as plt

    arrays = scene_arrays(sol, scenario, n_samples)
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    res = float(arrays["resolution"])
    origin = arrays["origin"]
    occ = arrays["occupied"]
    if len(occ):
        ax.scatter(
            origin[0] + (occ[:, 0] + 0.5) * res,
            origin[1] + (occ[:, 1] + 0.5) * res,
            s=2, c="0.6", marker="s", label="obstacles",
        )
    wp = arrays["waypoints"]
    ax.plot(wp[:, 0], wp[:, 1], "ro--", ms=4, lw=0.8, label="waypoints")
    tr = arrays["traj"]
    ax.plot(tr[:, 0], tr[:, 1], "b-", lw=1.5, label="optimized")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    return ax


def plot_esdf_layers(dist, origin, resolution, ax=None, max_dist=None,
                     n_layers: int = 8, z_slice: int | None = None):
    """Transparency-layered ESDF level sets (reference sdf_map.cpp:
    370-421: getESDFMarker renders one marker layer per distance level,
    alpha fading with distance).

    Draws ``n_layers`` level bands of the distance field on a top-down
    axis — cells with distance below level k get an overlay whose alpha
    decreases with k, so walls glow and free space fades out exactly
    like the reference's stacked rviz markers.  ``z_slice`` picks one
    z layer (default: column-min over z, the conservative top-down
    view).  Requires matplotlib.
    """
    import matplotlib.pyplot as plt

    dist = _host(dist)
    origin = _host(origin)
    res = float(_host(resolution).reshape(-1)[0])
    field = (
        dist[:, :, z_slice] if z_slice is not None else dist.min(axis=2)
    )
    if max_dist is None:
        # the reference scales alpha by the field's max (:423-431)
        max_dist = float(min(field.max(), 5.0)) or 1.0
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    extent = (
        origin[0], origin[0] + field.shape[0] * res,
        origin[1], origin[1] + field.shape[1] * res,
    )
    levels = np.linspace(max_dist / n_layers, max_dist, n_layers)
    for k, level in enumerate(levels):
        layer = (field <= level).astype(float)
        alpha = 0.8 * (1.0 - k / n_layers)
        ax.imshow(
            np.ma.masked_where(layer.T < 0.5, layer.T), origin="lower",
            extent=extent, cmap="Reds_r", alpha=alpha, vmin=0, vmax=1,
            interpolation="nearest",
        )
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(f"ESDF level sets (<= {max_dist:.1f} m, {n_layers} layers)")
    return ax


def plot_cost_curve(sol, ax=None):
    """Monotone best-cost envelope (reference getCostCurve)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(5, 3))
    trace = _host(sol.cost_trace)
    ax.semilogy(trace)
    ax.set_xlabel("iteration")
    ax.set_ylabel("best cost")
    return ax


def animate_trajectory(sol, scenario, path: str | None = None,
                       fps: int = 20, speedup: float = 1.0,
                       n_samples: int = 400, trail: bool = True):
    """Time-swept trajectory animation — the displayTrajectory marker
    sweep (display.h:57-158: a marker advances along the polynomial at
    wall-clock rate, leaving the traversed prefix drawn).

    Renders a top-down scene (obstacles, waypoints, full path faint)
    with a vehicle marker moving at ``speedup`` x real time; the
    traversed prefix draws solid when ``trail``.  Returns the
    matplotlib FuncAnimation; ``path`` saves it (.gif via pillow,
    .mp4 via ffmpeg when available, else falls back to a frame-dump
    directory of PNGs).
    """
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib import animation

    arrays = scene_arrays(sol, scenario, n_samples)
    tr, ts = arrays["traj"], arrays["t"]
    total_t = float(ts[-1])
    n_frames = max(2, int(total_t / speedup * fps))
    frame_t = np.linspace(0.0, total_t, n_frames)
    # frame -> last sample index at or before the frame time
    fidx = np.searchsorted(ts, frame_t, side="right") - 1

    fig, ax = plt.subplots(figsize=(6, 6))
    res = float(arrays["resolution"])
    origin = arrays["origin"]
    occ = arrays["occupied"]
    if len(occ):
        ax.scatter(
            origin[0] + (occ[:, 0] + 0.5) * res,
            origin[1] + (occ[:, 1] + 0.5) * res,
            s=2, c="0.6", marker="s",
        )
    wp = arrays["waypoints"]
    ax.plot(wp[:, 0], wp[:, 1], "ro--", ms=4, lw=0.8)
    ax.plot(tr[:, 0], tr[:, 1], "b-", lw=0.6, alpha=0.3)
    (trail_ln,) = ax.plot([], [], "b-", lw=1.8)
    (marker,) = ax.plot([], [], "ko", ms=7)
    title = ax.set_title("t = 0.00 s")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")

    def update(i):
        k = fidx[i]
        if trail:
            trail_ln.set_data(tr[: k + 1, 0], tr[: k + 1, 1])
        marker.set_data([tr[k, 0]], [tr[k, 1]])
        title.set_text(f"t = {frame_t[i]:.2f} s")
        return trail_ln, marker, title

    anim = animation.FuncAnimation(
        fig, update, frames=n_frames, interval=1000 / fps, blit=False
    )
    if path is not None:
        if path.endswith(".gif"):
            anim.save(path, writer="pillow", fps=fps)
        elif path.endswith(".mp4"):
            try:
                anim.save(path, writer="ffmpeg", fps=fps)
            except Exception:  # no ffmpeg: frame-dump fallback
                _dump_frames(fig, update, n_frames, path + ".frames")
        else:
            _dump_frames(fig, update, n_frames, path)
        plt.close(fig)
    return anim


def _dump_frames(fig, update, n_frames, out_dir: str):
    """Frame-dump export (one PNG per frame) for environments without
    a movie writer."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_frames):
        update(i)
        fig.savefig(f"{out_dir}/frame_{i:04d}.png", dpi=80)
    return out_dir
