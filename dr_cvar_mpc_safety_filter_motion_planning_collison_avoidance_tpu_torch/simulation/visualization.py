"""Visualization: trajectory plots, halfspace overlays, animations.

The port's own copy of the JAX package's simulation/visualization.py
(numpy and matplotlib only), with the same artifact set: scenario plots,
distance-to-collision plots incl. boxplot mode, risk-metric comparison
boxplots, halfspace-overlay figures, and FuncAnimation animations with
an ffmpeg -> pillow fallback.  Every function plots one scenario (no
leading batch axis) and takes numpy arrays or tensors on any device:
each entry goes through `to_numpy`.

This is the only module of the package that imports matplotlib, and the
package does not import it eagerly, so the package works where
matplotlib is not installed; importing this module there raises
ImportError.
"""

from __future__ import annotations

import os

import matplotlib

if not os.environ.get("DISPLAY"):
    matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
from matplotlib.animation import FuncAnimation, PillowWriter


def to_numpy(x):
    """A host numpy array from a tensor on any device (or anything
    `np.asarray` takes)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _robot_circle(ax, pos, radius, color, alpha=0.6, label=None):
    circle = plt.Circle(pos, radius, color=color, alpha=alpha, label=label)
    ax.add_patch(circle)
    return circle


def plot_scenario(ego_trajectory, obstacle_trajectories, robot_radius,
                  obstacle_radius, xlim=(-6, 6), ylim=(-4, 4), title=None,
                  save_path=None, ax=None):
    """Static scenario plot: ego + obstacle paths with start/end markers."""
    ego = to_numpy(ego_trajectory)
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(10, 8))
    ax.plot(ego[:, 0], ego[:, 1], "b-", linewidth=2, label="Ego")
    _robot_circle(ax, ego[0, :2], robot_radius, "blue", 0.3)
    _robot_circle(ax, ego[-1, :2], robot_radius, "blue", 0.6)
    for i, obs in enumerate(to_numpy(obstacle_trajectories)):
        ax.plot(obs[:, 0], obs[:, 1], "r--", linewidth=1.5,
                label=f"Obstacle {i + 1}" if i == 0 else None)
        _robot_circle(ax, obs[0], obstacle_radius, "red", 0.3)
        _robot_circle(ax, obs[-1], obstacle_radius, "red", 0.6)
    ax.set_xlim(xlim)
    ax.set_ylim(ylim)
    ax.set_aspect("equal")
    ax.grid(True)
    ax.legend(loc="upper right")
    if title:
        ax.set_title(title)
    if save_path and created:
        plt.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close()
    return ax


def plot_distance_to_collision(distances_by_metric, save_path=None,
                               boxplot=False, title="Distance to collision"):
    """Distance-over-time lines, or distribution boxplots when each entry
    holds per-run minima."""
    fig, ax = plt.subplots(figsize=(10, 6))
    if boxplot:
        names = list(distances_by_metric)
        ax.boxplot([to_numpy(distances_by_metric[k]) for k in names],
                   tick_labels=names)
        ax.axhline(y=0, color="r", linestyle="--", label="Collision threshold")
        ax.set_ylabel("Min distance")
    else:
        for name, dist in distances_by_metric.items():
            ax.plot(to_numpy(dist), label=name)
        ax.axhline(y=0, color="r", linestyle="--", label="Collision threshold")
        ax.set_xlabel("Time step")
        ax.set_ylabel("Distance")
        ax.legend()
    ax.set_title(title)
    ax.grid(True)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def compare_risk_metrics(min_distances_by_metric, save_path=None,
                         title="Risk metric comparison"):
    """Boxplot of per-run minimum distances per risk metric (fed by the
    Monte Carlo module)."""
    fig, ax = plt.subplots(figsize=(10, 6))
    names = list(min_distances_by_metric)
    ax.boxplot([to_numpy(min_distances_by_metric[k]) for k in names],
               tick_labels=names)
    ax.axhline(y=0, color="r", linestyle="--", label="Collision threshold")
    ax.set_ylabel("Minimum distance to collision")
    ax.set_title(title)
    ax.grid(True)
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def _halfspace_line(h, g, xlim, ylim):
    """Boundary segment of {y : h.y + g = 0} clipped to the plot box."""
    h = to_numpy(h).astype(float)
    g = float(to_numpy(g))
    pts = []
    if abs(h[1]) > 1e-9:
        for x in xlim:
            y = -(g + h[0] * x) / h[1]
            if ylim[0] - 1 <= y <= ylim[1] + 1:
                pts.append((x, y))
    if abs(h[0]) > 1e-9:
        for y in ylim:
            x = -(g + h[1] * y) / h[0]
            if xlim[0] - 1 <= x <= xlim[1] + 1:
                pts.append((x, y))
    if len(pts) < 2:
        return None
    pts = sorted(pts)[:2] if len(pts) > 2 else pts
    return np.array(pts)


def visualize_trajectory_with_halfspaces(ego_trajectory,
                                         obstacle_trajectories,
                                         halfspaces_h, halfspaces_g,
                                         robot_radius, obstacle_radius,
                                         xlim=(-6, 6), ylim=(-4, 4),
                                         title=None, save_path=None,
                                         step_stride=5):
    """Trajectory overlaid with halfspace boundaries at sampled steps,
    plus the grid-rasterized intersection of safe regions at mid-horizon."""
    ego = to_numpy(ego_trajectory)
    hs_h = to_numpy(halfspaces_h)  # [T, n_obs, 2]
    hs_g = to_numpy(halfspaces_g)  # [T, n_obs]
    fig, ax = plt.subplots(figsize=(10, 8))
    plot_scenario(ego, obstacle_trajectories, robot_radius, obstacle_radius,
                  xlim, ylim, ax=ax)

    n_steps = hs_h.shape[0]
    cmap = plt.get_cmap("viridis")
    for t in range(0, n_steps, step_stride):
        color = cmap(t / max(n_steps - 1, 1))
        for j in range(hs_h.shape[1]):
            seg = _halfspace_line(hs_h[t, j], hs_g[t, j], xlim, ylim)
            if seg is not None:
                ax.plot(seg[:, 0], seg[:, 1], "-", color=color, alpha=0.35,
                        linewidth=0.9)

    # Safe-region intersection at mid-horizon (rasterized).
    t_mid = n_steps // 2
    xs = np.linspace(*xlim, 200)
    ys = np.linspace(*ylim, 160)
    X, Y = np.meshgrid(xs, ys)
    safe = np.ones_like(X, dtype=bool)
    for j in range(hs_h.shape[1]):
        safe &= (hs_h[t_mid, j, 0] * X + hs_h[t_mid, j, 1] * Y
                 + hs_g[t_mid, j]) <= 0
    ax.contourf(X, Y, safe.astype(float), levels=[0.5, 1.5],
                colors=["green"], alpha=0.12)

    if title:
        ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def animate_scenario(ego_trajectory, obstacle_trajectories, robot_radius,
                     obstacle_radius, halfspaces_h=None, halfspaces_g=None,
                     xlim=(-6, 6), ylim=(-4, 4), title=None, interval=100,
                     save_path=None):
    """Animate ego + obstacles with per-frame halfspace boundaries and
    safe-direction arrows; saves via ffmpeg, falling back to a pillow GIF
    (same path, `.gif` suffix) when ffmpeg cannot write."""
    ego = to_numpy(ego_trajectory)
    obstacles = [to_numpy(o) for o in obstacle_trajectories]
    n_frames = min([len(ego)] + [len(o) for o in obstacles])

    fig, ax = plt.subplots(figsize=(10, 8))
    ax.set_xlim(xlim)
    ax.set_ylim(ylim)
    ax.set_aspect("equal")
    ax.grid(True)
    if title:
        ax.set_title(title)

    ego_line, = ax.plot([], [], "b-", linewidth=2, label="Ego")
    ego_patch = _robot_circle(ax, ego[0, :2], robot_radius, "blue", 0.6)
    obs_patches = [_robot_circle(ax, o[0], obstacle_radius, "red", 0.6)
                   for o in obstacles]
    hs_lines = []
    hs_arrows = []
    if halfspaces_h is not None:
        hs_h = to_numpy(halfspaces_h)
        hs_g = to_numpy(halfspaces_g)
        for _ in range(hs_h.shape[1]):
            line, = ax.plot([], [], "g-", alpha=0.7, linewidth=1.2)
            hs_lines.append(line)
            # Safe-direction arrow from the ego along -h/||h|| (the
            # direction into {y : h.y + g <= 0}), length 2*robot_radius.
            arrow = ax.quiver([ego[0, 0]], [ego[0, 1]], [0.0], [0.0],
                              color="green", alpha=0.4, angles="xy",
                              scale_units="xy", scale=1.0, width=0.008)
            hs_arrows.append(arrow)
    ax.legend(loc="upper right")

    def update(frame):
        ego_line.set_data(ego[:frame + 1, 0], ego[:frame + 1, 1])
        ego_patch.center = tuple(ego[frame, :2])
        for patch, obs in zip(obs_patches, obstacles):
            patch.center = tuple(obs[frame])
        if hs_lines and frame < hs_h.shape[0]:
            for j, (line, arrow) in enumerate(zip(hs_lines, hs_arrows)):
                seg = _halfspace_line(hs_h[frame, j], hs_g[frame, j],
                                      xlim, ylim)
                if seg is not None:
                    line.set_data(seg[:, 0], seg[:, 1])
                else:
                    line.set_data([], [])
                h = hs_h[frame, j]
                norm = np.linalg.norm(h)
                safe_dir = -h / norm if norm > 1e-9 else np.zeros(2)
                arrow.set_offsets([ego[frame, :2]])
                arrow.set_UVC([safe_dir[0] * 2 * robot_radius],
                              [safe_dir[1] * 2 * robot_radius])
        return [ego_line, ego_patch] + obs_patches + hs_lines + hs_arrows

    anim = FuncAnimation(fig, update, frames=n_frames, interval=interval,
                         blit=True)
    if save_path:
        try:
            anim.save(save_path, writer="ffmpeg", fps=max(1000 // interval, 1))
        except Exception:
            gif_path = os.path.splitext(save_path)[0] + ".gif"
            anim.save(gif_path, writer=PillowWriter(
                fps=max(1000 // interval, 1)))
        plt.close(fig)
    return anim, fig
