"""Offline map/frame rendering — the observability surface.

Replaces the Pangolin GL viewer stack (/root/reference/src/Viewer.cc,
MapDrawer.cc, FrameDrawer.cc) with matplotlib renderings that can be saved
per frame or at shutdown: the live GL loop has no place in a headless
deployment, and the fork itself ships offline matplotlib visualizers
(Scripts/Output_Process/visualize_trajectory.py) as its practical surface.

- ``draw_map``: landmarks + keyframe frusta + covisibility edges + current
  camera (MapDrawer::DrawMapPoints :135, DrawKeyFrames :178,
  DrawCurrentCamera :398).
- ``draw_frame``: current image with tracked/new keypoint overlays and the
  tracking-state banner (FrameDrawer::DrawFrame).
"""

from __future__ import annotations

import numpy as np

from ..models import map_state as ms


def _camera_wireframe(R, t, scale=0.1):
    """Frustum polyline in world coords for a world->cam pose."""
    w, h, z = 1.0 * scale, 0.75 * scale, 0.6 * scale
    pts_c = np.array([[0, 0, 0], [w, h, z], [-w, h, z], [-w, -h, z],
                      [w, -h, z]], np.float64)
    pts_w = (pts_c - t) @ R            # R^T (p - t)
    order = [0, 1, 2, 0, 3, 4, 0, 2, 3, 0, 4, 1]
    return pts_w[order]


def draw_map(state: ms.MapState, n_kf: int, ax=None, current_pose=None,
             show_covisibility=True, max_points=20000):
    """Render the map onto a 3D matplotlib axis (created if None)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")

    lm_valid = np.asarray(state.lms.valid)
    pos = np.asarray(state.lms.pos)[lm_valid]
    if len(pos) > max_points:
        pos = pos[:: len(pos) // max_points + 1]
    if len(pos):
        ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], s=0.5, c="0.3",
                   depthshade=False)

    Rs = np.asarray(state.kfs.R)
    ts = np.asarray(state.kfs.t)
    kf_valid = np.asarray(state.kfs.valid)
    centers = {}
    for k in range(n_kf):
        if not kf_valid[k]:
            continue
        wf = _camera_wireframe(Rs[k], ts[k])
        ax.plot(wf[:, 0], wf[:, 1], wf[:, 2], lw=0.5, c="tab:blue")
        centers[k] = -Rs[k].T @ ts[k]

    if show_covisibility and centers:
        # Covisibility edges above a weight threshold (MapDrawer draws the
        # graph with th=100; scaled down for small maps).
        obs_kf = np.asarray(state.obs.kf)
        obs_valid = np.asarray(state.obs.valid) & (obs_kf >= 0)
        ks = sorted(centers)
        sees = {k: ((obs_kf == k) & obs_valid).any(-1) for k in ks}
        for i, a in enumerate(ks):
            for b in ks[i + 1:]:
                w = int((sees[a] & sees[b]).sum())
                if w >= 15:
                    ca, cb = centers[a], centers[b]
                    ax.plot([ca[0], cb[0]], [ca[1], cb[1]], [ca[2], cb[2]],
                            lw=0.3, c="tab:green", alpha=0.6)

    if current_pose is not None:
        wf = _camera_wireframe(np.asarray(current_pose[0]),
                               np.asarray(current_pose[1]), scale=0.15)
        ax.plot(wf[:, 0], wf[:, 1], wf[:, 2], lw=1.2, c="tab:red")

    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    return ax


STATE_NAMES = {0: "NOT INITIALIZED", 1: "OK", 2: "RECENTLY LOST", 3: "LOST"}


def draw_frame(img: np.ndarray, feats, bindings=None, status: int = 1,
               n_kf: int = 0, n_lm: int = 0, ax=None):
    """Current frame with keypoint overlays + state banner.

    Tracked keypoints (bound to a landmark) draw as green squares, unbound
    detections as small blue dots (FrameDrawer::DrawFrame semantics).
    """
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(np.asarray(img), cmap="gray", vmin=0, vmax=255)
    xy = np.asarray(feats.xy)
    valid = np.asarray(feats.valid)
    if bindings is not None:
        bound = np.asarray(bindings) >= 0
        tracked = valid & bound
        free = valid & ~bound
    else:
        tracked = np.zeros_like(valid)
        free = valid
    if free.any():
        ax.scatter(xy[free, 0], xy[free, 1], s=3, c="tab:blue", marker=".")
    if tracked.any():
        ax.scatter(xy[tracked, 0], xy[tracked, 1], s=12, facecolors="none",
                   edgecolors="tab:green", marker="s", linewidths=0.8)
    banner = (f"{STATE_NAMES.get(status, '?')}  |  KFs: {n_kf}  "
              f"MPs: {n_lm}  |  matches: {int(tracked.sum())}")
    ax.set_title(banner, fontsize=10)
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    ax.axis("off")
    return ax


def snapshot(slam, path: str, img=None, feats=None):
    """One-call dump of the map (and optionally the current frame) to PNG —
    the practical equivalent of glancing at the Pangolin window."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if img is not None and feats is not None:
        fig = plt.figure(figsize=(14, 6))
        ax3 = fig.add_subplot(121, projection="3d")
        axf = fig.add_subplot(122)
        draw_frame(img, feats,
                   bindings=(slam._last or {}).get("bindings"),
                   status=slam.status, n_kf=slam.n_kf, n_lm=slam.n_lm,
                   ax=axf)
    else:
        fig = plt.figure(figsize=(8, 6))
        ax3 = fig.add_subplot(111, projection="3d")
    cur = None
    if slam._last is not None:
        cur = (np.asarray(slam._last["R"]), np.asarray(slam._last["t"]))
    draw_map(slam.state, slam.n_kf, ax=ax3, current_pose=cur)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
