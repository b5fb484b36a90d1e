"""ICL-NUIM / TUM-RGBD dataset reader (port of
visual_slam_tpu/utils/dataset.py:17-210).

The data layer for the reference's bundled dataset (`data/ICL_NUIM`:
associations.txt, rgb/, depth/ 16-bit PNG at scale 5000, traj3.gt.freiburg
TUM-format ground truth; SURVEY.md §1 "Data layer"). The reference
hard-codes paths and reads images ad hoc per frame (src/v2/frame.py:52-55,
with the depth-read bug noted in SURVEY §2.1 #4); here the reader is
explicit, returns float32 metric depth, and parses the TUM ground truth the
reference never reads (SURVEY §4). `frames()` decodes with the port's native
loader (`visual_slam_tpu_torch.native`) where it builds, and with PIL
otherwise; both are host IO.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

DEPTH_SCALE = 5000.0  # TUM/ICL 16-bit PNG convention (src/testing.py cell 2)
ICL_INTRINSICS = np.array([481.20, 480.0, 319.5, 239.5], dtype=np.float32)
TUM_FR3_INTRINSICS = np.array([535.4, 539.2, 320.1, 247.6], dtype=np.float32)


def _imread(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))


@dataclass
class Association:
    index: int
    depth_path: str
    rgb_path: str


@dataclass
class ICLNUIMDataset:
    """Reader for the ICL-NUIM living-room layout the reference bundles."""

    root: str
    gt_file: str | None = None
    associations: list[Association] = field(default_factory=list)
    intrinsics: np.ndarray = field(default_factory=lambda: ICL_INTRINSICS.copy())

    def __post_init__(self):
        assoc_path = os.path.join(self.root, "associations.txt")
        with open(assoc_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 4:
                    continue
                self.associations.append(
                    Association(
                        index=int(parts[0]),
                        depth_path=os.path.join(self.root, parts[1]),
                        rgb_path=os.path.join(self.root, parts[3]),
                    )
                )
        if self.gt_file is None:
            cand = os.path.join(self.root, "traj3.gt.freiburg")
            if os.path.exists(cand):
                self.gt_file = cand

    def __len__(self) -> int:
        return len(self.associations)

    def rgb(self, i: int) -> np.ndarray:
        """(H,W,3) uint8."""
        return _imread(self.associations[i].rgb_path)

    def depth(self, i: int) -> np.ndarray:
        """(H,W) float32 metres (16-bit PNG / 5000); 0 = missing."""
        raw = _imread(self.associations[i].depth_path).astype(np.float32)
        return raw / DEPTH_SCALE

    def gray(self, i: int) -> np.ndarray:
        """(H,W) float32 grayscale in [0,1]."""
        rgb = self.rgb(i).astype(np.float32) / 255.0
        return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]

    def frames(self, start: int = 0, stop: int | None = None) -> Iterator[tuple[int, np.ndarray, np.ndarray]]:
        """Yield (idx, gray, depth). With the native loader available, gray
        is uint8 and decode runs in the C++ thread pool (prefetched ahead of
        the consumer); the PIL fallback yields float32 gray. The front-end
        takes both (frontend.to_gray normalizes by dtype)."""
        stop = stop if stop is not None else len(self)
        from .. import native

        if native.available():
            loader, off = self.async_loader(start, stop)
            try:
                for i in range(start, stop):
                    gray, depth = loader.get_gray(i - off)
                    yield i, gray, depth
            finally:
                loader.close()
            return
        for i in range(start, stop):
            yield i, self.gray(i), self.depth(i)

    def async_loader(self, start: int = 0, stop: int | None = None, **kw):
        """Native (C++) prefetching loader over [start, stop), see
        visual_slam_tpu_torch.native. Returns (loader, index_offset): frame
        i of the dataset is loader.get(i - index_offset)."""
        from .. import native

        stop = stop if stop is not None else len(self)
        rgb = [self.associations[i].rgb_path for i in range(start, stop)]
        dep = [self.associations[i].depth_path for i in range(start, stop)]
        return native.AsyncFrameLoader(rgb, dep, **kw), start

    def async_frames(self, start: int = 0, stop: int | None = None):
        """Iterator like `frames` but fed by the native async loader
        (decode overlaps consumer compute); falls back to sync PIL reads."""
        from .. import native

        if not native.available():
            yield from ((i, self.rgb(i), self.depth(i)) for i in range(start, stop or len(self)))
            return
        loader, off = self.async_loader(start, stop)
        try:
            for i in range(start, stop if stop is not None else len(self)):
                rgb, depth = loader.get(i - off)
                yield i, rgb, depth
        finally:
            loader.close()

    def ground_truth(self) -> np.ndarray | None:
        """(N, 4, 4) cam->world poses from the TUM-format file, or None.

        File format: `idx tx ty tz qx qy qz qw` per line
        (data/ICL_NUIM/traj3.gt.freiburg; first index is 1).
        """
        if self.gt_file is None:
            return None
        rows = np.loadtxt(self.gt_file)
        return tum_rows_to_matrices(rows)


@dataclass
class WindowView:
    """A pseudo-sequence view over a dataset: offset / strided / reversed
    frame window. Used to synthesize DISTINCT sequences for the batched
    multi-sequence run (BASELINE config #3) when only one physical
    sequence exists locally — e.g. WindowView(ds, 100) and
    WindowView(ds, 300, reverse=True) exercise genuinely different
    trajectories through the same scene."""

    base: "ICLNUIMDataset"
    offset: int = 0
    length: int | None = None
    step: int = 1
    reverse: bool = False

    @property
    def intrinsics(self):
        return self.base.intrinsics

    def __len__(self) -> int:
        n = (len(self.base) - self.offset) // max(self.step, 1)
        return n if self.length is None else min(self.length, n)

    def _map(self, i: int) -> int:
        n = len(self)
        j = (n - 1 - i) if self.reverse else i
        return self.offset + j * self.step

    def rgb(self, i: int) -> np.ndarray:
        return self.base.rgb(self._map(i))

    def depth(self, i: int) -> np.ndarray:
        return self.base.depth(self._map(i))

    def gray(self, i: int) -> np.ndarray:
        return self.base.gray(self._map(i))

    def frames(self, start: int = 0, stop: int | None = None):
        stop = stop if stop is not None else len(self)
        for i in range(start, stop):
            yield i, self.gray(i), self.depth(i)

    def ground_truth(self) -> np.ndarray | None:
        """Ground truth reindexed to this view's frame numbering."""
        gt = self.base.ground_truth()
        if gt is None:
            return None
        idx = np.array([self._map(i) for i in range(len(self))])
        return gt[np.clip(idx, 0, len(gt) - 1)]


def tum_rows_to_matrices(rows: np.ndarray) -> np.ndarray:
    """TUM rows (N,8) -> (N,4,4) cam->world homogeneous transforms."""
    t = rows[:, 1:4]
    q = rows[:, 4:8]  # qx qy qz qw
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    n = x * x + y * y + z * z + w * w
    s = np.where(n > 0, 2.0 / np.maximum(n, 1e-12), 0.0)
    R = np.stack(
        [
            1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w),
            s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w),
            s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(-1, 3, 3)
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    return T.astype(np.float64)
