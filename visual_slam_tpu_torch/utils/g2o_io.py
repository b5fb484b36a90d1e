"""g2o text-format export and import for pose graphs and landmarks (port of
visual_slam_tpu/utils/g2o_io.py; NumPy only, the same text for the same
inputs).

Interop with the reference's graph serialisation: `optimizer.save_to_file`
dumps (LocalBA.py:44-45; geohot_BA.py:153-155 writes before.g2o/after.g2o)
and `graphslam.load_g2o_se3` reloads (visualizeGraph.py:1-5). Formats:
  VERTEX_SE3:QUAT id tx ty tz qx qy qz qw        (camera pose, cam->world)
  VERTEX_TRACKXYZ id x y z                       (landmark)
  EDGE_SE3:QUAT i j tx ty tz qx qy qz qw <21 upper-tri info entries>
Poses and points print with 9 decimals, the information entries with 6.
"""
from __future__ import annotations

import numpy as np


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            qx, qw = 0.25 * s, (R[2, 1] - R[1, 2]) / s
            qy = (R[0, 1] + R[1, 0]) / s
            qz = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            qy, qw = 0.25 * s, (R[0, 2] - R[2, 0]) / s
            qx = (R[0, 1] + R[1, 0]) / s
            qz = (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            qz, qw = 0.25 * s, (R[1, 0] - R[0, 1]) / s
            qx = (R[0, 2] + R[2, 0]) / s
            qy = (R[1, 2] + R[2, 1]) / s
    return np.array([qx, qy, qz, qw])


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 2.0 / max(n, 1e-12)
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


def save_pose_graph(
    path: str,
    R_cw: np.ndarray,
    t_cw: np.ndarray,
    valid: np.ndarray,
    edges: list[tuple[int, int, np.ndarray, np.ndarray]] | None = None,
    points: np.ndarray | None = None,
    point_valid: np.ndarray | None = None,
) -> None:
    """Write VERTEX_SE3:QUAT (cam->world, g2o convention) + optional
    landmarks and EDGE_SE3:QUAT entries."""
    lines = []
    for k in range(len(R_cw)):
        if not valid[k]:
            continue
        # world->cam stored internally; g2o vertices are cam->world.
        R_wc = R_cw[k].T
        t_wc = -R_cw[k].T @ t_cw[k]
        q = _rot_to_quat(R_wc)
        lines.append(
            f"VERTEX_SE3:QUAT {k} "
            + " ".join(f"{v:.9f}" for v in (*t_wc, *q))
        )
    if points is not None:
        base = len(R_cw)
        for p in range(len(points)):
            if point_valid is not None and not point_valid[p]:
                continue
            lines.append(
                f"VERTEX_TRACKXYZ {base + p} "
                + " ".join(f"{v:.9f}" for v in points[p])
            )
    if edges:
        info = np.eye(6)
        info_str = " ".join(
            f"{info[i, j]:.6f}" for i in range(6) for j in range(i, 6)
        )
        for (i, j, R_rel, t_rel) in edges:
            q = _rot_to_quat(R_rel)
            lines.append(
                f"EDGE_SE3:QUAT {i} {j} "
                + " ".join(f"{v:.9f}" for v in (*t_rel, *q))
                + " "
                + info_str
            )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_pose_graph(path: str):
    """Read VERTEX_SE3:QUAT / VERTEX_TRACKXYZ / EDGE_SE3:QUAT.

    Returns (poses {id: (R_wc, t_wc)}, points {id: xyz}, edges list).
    """
    poses: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    points: dict[int, np.ndarray] = {}
    edges = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "VERTEX_SE3:QUAT":
                vid = int(parts[1])
                vals = np.array([float(v) for v in parts[2:9]])
                poses[vid] = (_quat_to_rot(vals[3:7]), vals[:3])
            elif parts[0] == "VERTEX_TRACKXYZ":
                points[int(parts[1])] = np.array([float(v) for v in parts[2:5]])
            elif parts[0] == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                vals = np.array([float(v) for v in parts[3:10]])
                edges.append((i, j, _quat_to_rot(vals[3:7]), vals[:3]))
    return poses, points, edges
