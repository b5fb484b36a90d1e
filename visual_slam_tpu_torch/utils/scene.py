"""Deterministic synthetic RGB-D sequence, for tests and the smoke run.

A camera moves inside a closed box room whose six walls carry multi-scale
smoothed-noise textures (about one texel per pixel at 3 m). Each pixel's
ray is cast against the box planes and the wall texture sampled bilinearly
(scipy.ndimage.map_coordinates). A box and not a single plane: DLT PnP is
degenerate on a planar scene.

The sequence exposes the dataset reader's interface (`frames(start, stop)`
yielding (idx, gray, depth), and `ground_truth()` as (N,4,4) camera->world
poses), so `run_sequence` takes it in place of ICL-NUIM. Images are float32
gray in [0,1] and float32 metric z-depth; the world frame is frame 0's
camera frame (x right, y down, z forward). Everything is NumPy/SciPy, made
from `seed`.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
from scipy import ndimage

ICL_INTRINSICS = np.array([481.20, 480.0, 319.5, 239.5], np.float32)

# Room extent (metres) along x, y, z in the frame-0 camera frame.
ROOM_LO = np.array([-1.2, -0.9, -1.0])
ROOM_HI = np.array([1.2, 0.9, 3.0])
TEXEL = 0.006  # metres: ~1 texel per pixel at 3 m with fx ~ 480
_SCALES = ((1.0, 0.35), (2.5, 0.30), (6.0, 0.20), (15.0, 0.15))  # (sigma texels, weight)


def _rotation(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """R = Ry(yaw) @ Rx(pitch) @ Rz(roll), angles in radians."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return Ry @ Rx @ Rz


class SyntheticRGBDScene:
    """A rendered RGB-D sequence of `n_frames` frames of `height` x `width`.

    Over 60 frames the camera travels ~0.3 m and turns ~5°, so the first
    frame's landmarks stay in view throughout; the motion continues at the
    same rate for longer sequences.
    """

    def __init__(self, n_frames: int = 60, height: int = 480, width: int = 640,
                 intrinsics: np.ndarray | None = None, seed: int = 0):
        self.n_frames = n_frames
        self.height, self.width = height, width
        self.intrinsics = (
            ICL_INTRINSICS.copy() if intrinsics is None
            else np.asarray(intrinsics, np.float32)
        )
        rng = np.random.default_rng(seed)
        # One texture per face; face (axis a, side s) spans the other two axes.
        self._faces = []
        for a in range(3):
            b, c = [k for k in range(3) if k != a]
            shape = tuple(
                int(np.ceil((ROOM_HI[k] - ROOM_LO[k]) / TEXEL)) + 2 for k in (b, c)
            )
            for side in (0, 1):
                self._faces.append((a, side, b, c, self._texture(rng, shape)))
        self._R_wc, self._C = zip(*(self._pose_wc(i) for i in range(n_frames)))

    @staticmethod
    def _texture(rng: np.random.Generator, shape) -> np.ndarray:
        tex = np.zeros(shape)
        for sigma, weight in _SCALES:
            layer = ndimage.gaussian_filter(rng.standard_normal(shape), sigma)
            tex += weight * layer / layer.std()
        tex = 0.5 + 0.2 * rng.uniform(-1, 1) + 0.18 * tex / tex.std()
        return np.clip(tex, 0.0, 1.0)

    @staticmethod
    def _pose_wc(i: int):
        """Camera->world rotation and camera centre of frame i."""
        s = i / 59.0
        C = np.array([0.25 * s, -0.05 * np.sin(np.pi * s), 0.15 * s])
        deg = np.pi / 180.0
        R = _rotation(4.0 * deg * s, 2.0 * deg * np.sin(np.pi * s), 1.0 * deg * s)
        return R, C

    def __len__(self) -> int:
        return self.n_frames

    def pose_cw(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """World->camera (R_cw (3,3), t_cw (3,)) of frame i, float64."""
        R_cw = self._R_wc[i].T
        return R_cw, -R_cw @ self._C[i]

    def render(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(gray (H,W) float32 in [0,1], depth (H,W) float32 metres)."""
        fx, fy, cx, cy = self.intrinsics.astype(np.float64)
        v, u = np.mgrid[0:self.height, 0:self.width].astype(np.float64)
        d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
        d = d_cam @ self._R_wc[i].T  # world-frame ray directions, z_cam = 1
        C = self._C[i]
        # From inside the box, each ray leaves through exactly one face: the
        # nearest positive crossing over the three axes.
        with np.errstate(divide="ignore"):
            t_axis = np.where(
                d > 0, (ROOM_HI - C) / d, np.where(d < 0, (ROOM_LO - C) / d, np.inf)
            )
        axis = np.argmin(t_axis, axis=-1)
        depth = np.take_along_axis(t_axis, axis[..., None], axis=-1)[..., 0]
        side = np.take_along_axis(d, axis[..., None], axis=-1)[..., 0] > 0
        P = C + depth[..., None] * d
        gray = np.zeros(depth.shape)
        for a, s, b, c, tex in self._faces:
            m = (axis == a) & (side == bool(s))
            coords = [(P[m, k] - ROOM_LO[k]) / TEXEL for k in (b, c)]
            gray[m] = ndimage.map_coordinates(tex, coords, order=1, mode="nearest")
        return gray.astype(np.float32), depth.astype(np.float32)

    def frames(self, start: int = 0, stop: int | None = None
               ) -> Iterator[tuple[int, np.ndarray, np.ndarray]]:
        """Yield (idx, gray, depth) for frames [start, stop)."""
        stop = self.n_frames if stop is None else stop
        for i in range(start, stop):
            gray, depth = self.render(i)
            yield i, gray, depth

    def ground_truth(self) -> np.ndarray:
        """(N,4,4) camera->world poses, like the ICL-NUIM reader's."""
        T = np.tile(np.eye(4), (self.n_frames, 1, 1))
        T[:, :3, :3] = np.stack(self._R_wc)
        T[:, :3, 3] = np.stack(self._C)
        return T
