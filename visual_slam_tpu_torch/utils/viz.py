"""Host-side visualisation and export (port of visual_slam_tpu/utils/viz.py).

Replaces the reference's Pangolin process viewer (src/v2/viewer.py:9-257)
with headless artifacts (SURVEY.md §2.2): trajectory plots, map-point PLY
export, match-overlay images, and `LiveView`, the per-frame callback that
keeps a watch directory current. matplotlib and PIL are imported where a
function draws, never when this module is imported.
"""
from __future__ import annotations

import json
import os

import numpy as np


def plot_trajectory(est_positions: np.ndarray, gt_positions: np.ndarray | None = None,
                    path: str = "trajectory.png", title: str = "trajectory") -> None:
    """Top-down (x,z) and side (x,y) trajectory plot saved as PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, (i, j, name) in zip(axes, [(0, 2, "x/z"), (0, 1, "x/y")]):
        ax.plot(est_positions[:, i], est_positions[:, j], "b-", label="estimate")
        if gt_positions is not None:
            ax.plot(gt_positions[:, i], gt_positions[:, j], "g--", label="ground truth")
        ax.set_xlabel(name.split("/")[0])
        ax.set_ylabel(name.split("/")[1])
        ax.axis("equal")
        ax.legend()
    fig.suptitle(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def save_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None,
             valid: np.ndarray | None = None) -> None:
    """Write map points as an ASCII PLY point cloud (the JAX package's
    bytes for the same inputs)."""
    if valid is not None:
        points = points[valid]
        if colors is not None:
            colors = colors[valid]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        # One savetxt, not a Python loop: LiveView writes this during a run.
        if colors is not None:
            body = np.concatenate([np.asarray(points, np.float64),
                                   np.asarray(colors, np.float64)], axis=1)
            np.savetxt(f, body, fmt="%.5f %.5f %.5f %d %d %d")
        else:
            np.savetxt(f, np.asarray(points, np.float64), fmt="%.5f")


def _overlay_image(gray: np.ndarray, uv_prev: np.ndarray | None, uv_cur: np.ndarray | None):
    """RGB PIL image: the camera frame with tracked-match lines drawn from
    each landmark's keyframe pixel to its current pixel (red circle)."""
    from PIL import Image, ImageDraw

    g = np.asarray(gray)
    if g.dtype != np.uint8:
        g = np.clip(g * 255.0, 0, 255).astype(np.uint8)
    img = Image.fromarray(g).convert("RGB")
    d = ImageDraw.Draw(img)
    if uv_cur is not None and len(uv_cur):
        if uv_prev is not None and len(uv_prev) == len(uv_cur):
            for (x0, y0), (x1, y1) in zip(uv_prev, uv_cur):
                d.line([(float(x0), float(y0)), (float(x1), float(y1))],
                       fill=(60, 220, 60), width=1)
        for x1, y1 in uv_cur:
            d.ellipse([float(x1) - 2, float(y1) - 2, float(x1) + 2, float(y1) + 2],
                      outline=(230, 60, 60))
    return img


class LiveView:
    """Incremental headless viewer, the run-time analog of the reference's
    Pangolin process (src/v2/viewer.py:9-257). Every `every` frames it
    rewrites a watch directory:

      state.json       frame index, keyframe and point counts, position
      trajectory.json  the camera centres, for utils/viewer.html
      trajectory.png   top-down and side trajectory (with ground truth)
      map.ply          the current landmark cloud
      frame.png        the camera image with a tracked-match overlay, when
                       the caller passes the frame

    Each file is written to `.tmp.<name>` and os.replace()d into place, so
    a watcher always reads a complete artifact. Use it as `on_frame` of
    pipeline.run_sequence, or through the command line:
    `python -m visual_slam_tpu_torch.pipeline --data DIR --live-dump LIVE`.
    """

    def __init__(self, out_dir: str, every: int = 25, gt_positions: np.ndarray | None = None,
                 plot: bool = True):
        self.out_dir = out_dir
        self.every = max(int(every), 1)
        self.gt = gt_positions
        self.plot = plot
        self.n_updates = 0
        self._last = None
        os.makedirs(out_dir, exist_ok=True)

    def _atomic(self, name: str) -> tuple[str, str]:
        """(temporary path, final path); the temporary keeps the extension
        (matplotlib picks the image format from it)."""
        return os.path.join(self.out_dir, ".tmp." + name), os.path.join(self.out_dir, name)

    def __call__(self, slam, frame_idx: int, gray: np.ndarray | None = None,
                 uv_prev: np.ndarray | None = None, uv_cur: np.ndarray | None = None) -> None:
        if self._last is not None and frame_idx - self._last < self.every:
            return
        self._last = frame_idx
        self.n_updates += 1
        if gray is not None:
            tmp, path = self._atomic("frame.png")
            _overlay_image(gray, uv_prev, uv_cur).save(tmp, format="PNG")
            os.replace(tmp, path)

        idxs, est = slam.positions()
        state = {
            "frame": int(frame_idx),
            "initialized": bool(slam.initialized),
            "keyframes": int(slam.stats.get("keyframes", 0)),
            "points": int(np.asarray(slam.map.pt_valid).sum()),
            "trajectory_len": len(idxs),
            "position": [float(x) for x in est[-1]] if len(est) else None,
            "updates": self.n_updates,
        }
        tmp, path = self._atomic("state.json")
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, path)

        tmp, path = self._atomic("trajectory.json")
        with open(tmp, "w") as f:
            json.dump({"positions": np.asarray(est, np.float64).round(5).tolist()}, f)
        os.replace(tmp, path)

        if len(est) >= 2 and self.plot:
            gt = None
            if self.gt is not None:
                gt = self.gt[np.clip(np.asarray(idxs), 0, len(self.gt) - 1)]
            tmp, path = self._atomic("trajectory.png")
            plot_trajectory(est, gt, tmp, title=f"frame {frame_idx}")
            os.replace(tmp, path)

        if state["points"]:
            tmp, path = self._atomic("map.ply")
            save_ply(tmp, np.asarray(slam.map.pt_xyz),
                     valid=np.asarray(slam.map.pt_valid).astype(bool))
            os.replace(tmp, path)


def draw_matches(img1: np.ndarray, uv1: np.ndarray, img2: np.ndarray, uv2: np.ndarray,
                 good: np.ndarray, path: str = "matches.png") -> None:
    """Side-by-side match visualisation (the cv2.drawMatchesKnn overlay the
    reference feeds its viewer, src/v2/main.py:216)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h = max(img1.shape[0], img2.shape[0])
    w = img1.shape[1] + img2.shape[1]
    canvas = np.zeros((h, w), np.float32)
    canvas[: img1.shape[0], : img1.shape[1]] = img1
    canvas[: img2.shape[0], img1.shape[1]:] = img2
    fig, ax = plt.subplots(figsize=(14, 6))
    ax.imshow(canvas, cmap="gray")
    off = img1.shape[1]
    for i in np.where(good)[0]:
        ax.plot([uv1[i, 0], uv2[i, 0] + off], [uv1[i, 1], uv2[i, 1]], "-", lw=0.5, alpha=0.6)
    ax.axis("off")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
