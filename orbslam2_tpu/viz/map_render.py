"""Headless map/trajectory visualization.

Replaces the reference's Pangolin Viewer/FrameDrawer/MapDrawer triad
(src/Viewer.cpp, src/FrameDrawer.cpp, src/MapDrawer.cpp) with offline
renders: a top-down map plot (points, keyframe frusta, covisibility edges,
trajectory) and a frame overlay (keypoints colored by tracking state).
PNG output via matplotlib's Agg backend — no GL window needed on a headless server.
"""
from __future__ import annotations

import numpy as np


def render_map_topdown(mp, trajectory=None, path="map.png",
                       axes=(0, 2), show_covisibility=True,
                       show_points=True, center=None, span=6.0):
    """Top-down (x-z by default) map plot.

    mp: MapState; trajectory: optional [F, 3, 4] Tcw frame poses.
    path: filename or binary file-like object (live viewer).
    center: optional world point to center the view on (the Viewer's
    "follow camera" mode, src/Viewer.cpp:128-138) with half-extent `span`.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a, b = axes
    fig, ax = plt.subplots(figsize=(9, 9))
    pts = mp.pt_xyz[mp.pt_valid]
    if show_points and len(pts):
        ax.scatter(pts[:, a], pts[:, b], s=1, c="#777777", alpha=0.4,
                   label=f"{len(pts)} points")
    kf_ids = mp.kf_ids
    centers = []
    for k in kf_ids:
        T = mp.kf_pose[k]
        C = -T[:, :3].T @ T[:, 3]
        centers.append(C)
        # frustum direction
        z_dir = T[2, :3]  # camera z axis in world (row of R = Rcw)
        ax.annotate("", xy=(C[a] + 0.12 * z_dir[a], C[b] + 0.12 * z_dir[b]),
                    xytext=(C[a], C[b]),
                    arrowprops=dict(arrowstyle="->", color="tab:blue", lw=1))
    centers = np.array(centers) if len(centers) else np.zeros((0, 3))
    if len(centers):
        ax.scatter(centers[:, a], centers[:, b], s=25, c="tab:blue",
                   marker="s", label=f"{len(centers)} keyframes")
    if show_covisibility and len(kf_ids) > 1:
        for i, k in enumerate(kf_ids):
            w = mp.covisibility_weights(int(k))
            for j_pos, j in enumerate(kf_ids):
                if j <= k or w[j] < 100:
                    continue
                ax.plot([centers[i, a], centers[j_pos, a]],
                        [centers[i, b], centers[j_pos, b]],
                        c="tab:green", lw=0.5, alpha=0.5)
    if trajectory is not None and len(trajectory):
        C = np.stack([-T[:, :3].T @ T[:, 3] for T in trajectory])
        ax.plot(C[:, a], C[:, b], c="tab:red", lw=1.2, label="trajectory")
    ax.set_aspect("equal")
    if center is not None:
        ax.set_xlim(center[a] - span, center[a] + span)
        ax.set_ylim(center[b] - span, center[b] + span)
    ax.legend(loc="upper right", fontsize=8)
    ax.set_xlabel("xyz"[a])
    ax.set_ylabel("xyz"[b])
    fig.savefig(path, dpi=110, bbox_inches="tight", format="png")
    plt.close(fig)
    return path


def render_frame_overlay(img, frame, path="frame.png"):
    """Keypoint overlay (FrameDrawer equivalent): green = tracked map point,
    yellow = detected only."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 7.5))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    if frame.xy_raw is None:
        # lazy block-driver frame whose features were never materialized:
        # draw the image alone rather than forcing a device fetch from the
        # viewer thread
        ax.set_title(f"frame {frame.frame_id}")
        ax.axis("off")
        fig.savefig(path, dpi=100, bbox_inches="tight", format="png")
        plt.close(fig)
        return path
    v = frame.valid
    tracked = v & (frame.pt_idx >= 0)
    ax.scatter(frame.xy_raw[v & ~tracked, 0], frame.xy_raw[v & ~tracked, 1],
               s=6, facecolors="none", edgecolors="yellow", linewidths=0.6)
    ax.scatter(frame.xy_raw[tracked, 0], frame.xy_raw[tracked, 1],
               s=8, facecolors="none", edgecolors="lime", linewidths=0.8)
    ax.set_title(f"frame {frame.frame_id}: {tracked.sum()} tracked / "
                 f"{v.sum()} keypoints")
    ax.axis("off")
    fig.savefig(path, dpi=100, bbox_inches="tight", format="png")
    plt.close(fig)
    return path
