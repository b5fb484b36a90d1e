"""Synthetic bundle-adjustment problems: the large map of BASELINE.json
config #5 (port of visual_slam_tpu/utils/synthetic.py) and the small arc of
the online-BA tests; a 5,000-keyframe pose graph (`big_pose_graph`, the
draws of tests/test_pose_graph.py:158 `make_big_graph`); the small problem of
the multi-process BA test (`multihost_problem`); and `RingScene`, a drifted keyframe ring loaded into a
Slam, on which a loop closure is decided (port of
tests/test_loop_operating_point.py:73-216, drawn in the same order).

A loop trajectory of K cameras observing P landmarks Q times each, emitted
directly in the packed planar BAProblem layout (point p's Q observation
slots are consecutive). The draws of `np.random.RandomState(seed)` come in
the JAX package's order, so both packages build the same problem from the
same seed; the geometry is NumPy on the host, and the problem is then put
on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.ba import BAProblem, make_problem
from ..models.frontend import Features
from ..ops import lie


def build_loop_map(K: int, P: int, Q: int, seed: int = 0, device="cuda"):
    """Synthetic config-#5 map. Returns (BAProblem on `device`,
    (R_cw, t_cw, X_gt) as NumPy ground truth)."""
    rng = np.random.RandomState(seed)
    # Loop trajectory: cameras on a circle, yawing along it.
    ang = 2 * np.pi * np.arange(K) / K
    radius = 8.0
    t_gt = np.stack(
        [radius * np.cos(ang), radius * np.sin(ang), 0.05 * np.sin(5 * ang)], -1
    ).astype(np.float32)
    # Camera-to-world axes (columns): forward z_cam tangent to the circle.
    yaw = ang + np.pi / 2
    cy, sy = np.cos(yaw), np.sin(yaw)
    zero = np.zeros_like(cy)
    one = np.ones_like(cy)
    x_cam = np.stack([-sy, cy, zero], -1)
    y_cam = np.stack([zero, zero, one], -1)
    z_cam = np.stack([cy, sy, zero], -1)
    R_gt = np.stack([x_cam, y_cam, z_cam], axis=-1).astype(np.float32)
    R_cw = np.transpose(R_gt, (0, 2, 1)).copy()
    t_cw = -np.einsum("kij,kj->ki", R_cw, t_gt).astype(np.float32)
    # Each point is anchored near a camera's frustum and observed by Q
    # cameras strided along the loop (the stride gives triangulation
    # parallax; consecutive cameras are near-identical viewpoints).
    stride = max(1, K // 128)
    base = rng.randint(0, K - Q * stride, P).astype(np.int32)
    C = t_gt[base]
    fwd = np.stack([np.cos(yaw[base]), np.sin(yaw[base]), 0 * yaw[base]], -1)
    X_gt = (C + fwd * rng.uniform(4.0, 9.0, (P, 1)) + rng.normal(0, 0.8, (P, 3))).astype(np.float32)
    cam = (base[:, None] + stride * np.arange(Q)[None, :]).reshape(-1).astype(np.int32)
    intr = np.array([481.2, 480.0, 319.5, 239.5], np.float32)
    Rn = R_cw[cam]
    Xn = np.repeat(X_gt, Q, axis=0)
    Xc = np.einsum("nij,nj->ni", Rn, Xn) + t_cw[cam]
    z = Xc[:, 2]
    uv = np.stack(
        [
            intr[0] * Xc[:, 0] / np.maximum(z, 1e-3) + intr[2],
            intr[1] * Xc[:, 1] / np.maximum(z, 1e-3) + intr[3],
        ],
        -1,
    ).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    w = (z > 0.2).astype(np.float32)  # behind-camera slots are dead weight
    # Perturb the initial estimates.
    dw = rng.normal(0, 0.004, (K, 3)).astype(np.float32)
    dR = lie.so3_exp(torch.from_numpy(dw)).numpy()
    R0 = np.einsum("kij,kjl->kil", dR, R_cw).astype(np.float32)
    t0 = np.einsum("kij,kj->ki", dR, t_cw).astype(np.float32) + rng.normal(
        0, 0.02, (K, 3)
    ).astype(np.float32)
    R0[0], t0[0] = R_cw[0], t_cw[0]
    X0 = X_gt + rng.normal(0, 0.05, X_gt.shape).astype(np.float32)
    cam_fixed = np.zeros(K, bool)
    cam_fixed[0] = True

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    N = len(cam)
    zeros_f = torch.zeros(1, dtype=torch.float32, device=device)
    prob = BAProblem(
        R=dev(R0),
        t=dev(t0),
        X=dev(X0),
        pt_valid=torch.ones(P, dtype=torch.float32, device=device),
        cam=dev(cam),
        uv=dev(uv.T),
        w=dev(w),
        intr=dev(intr),
        cam_fixed=dev(cam_fixed),
        se_i=torch.zeros(1, dtype=torch.int32, device=device),
        se_j=torch.zeros(1, dtype=torch.int32, device=device),
        se_meas=zeros_f,
        se_w=zeros_f.clone(),
        dinv=torch.zeros(N, dtype=torch.float32, device=device),
        dw=torch.zeros(N, dtype=torch.float32, device=device),
    )
    return prob, (R_cw, t_cw, X_gt)


INTR = np.array([481.20, 480.0, 319.5, 239.5], np.float32)  # ICL-NUIM


def arc_problem(K: int = 6, P: int = 300, noise_px: float = 0.0, pose_noise: float = 0.0,
                point_noise: float = 0.0, seed: int = 0, device="cuda"):
    """An online-BA problem: K cameras on an arc (turning 0.04 rad per
    camera) looking at P points, full visibility, built with
    ba.make_problem (port of tests/test_ba.py:synth_problem; the NumPy draws
    of `np.random.default_rng(seed)` come in that helper's order). Camera 0
    is exact and fixed. Returns (BAProblem on `device`, (R_gt, t_gt, X_gt))."""
    rng = np.random.default_rng(seed)
    X = np.stack(
        [rng.uniform(-2, 2, size=P), rng.uniform(-1.5, 1.5, size=P), rng.uniform(4, 8, size=P)],
        axis=-1,
    ).astype(np.float32)

    def rot(w):
        return lie.so3_exp(torch.from_numpy(np.asarray(w, np.float32))).numpy()

    Rs, ts, uvs = [], [], []
    for k in range(K):
        R = rot([0.01 * k, -0.04 * k, 0.015 * k])
        t = np.array([0.25 * k, 0.02 * k, 0.01 * k], dtype=np.float32)
        Rs.append(R)
        ts.append(t)
        Xc = X @ R.T + t
        uv = np.stack([INTR[0] * Xc[:, 0] / Xc[:, 2] + INTR[2],
                       INTR[1] * Xc[:, 1] / Xc[:, 2] + INTR[3]], axis=-1)
        uvs.append(uv + rng.normal(scale=noise_px, size=uv.shape))
    R_gt, t_gt = np.stack(Rs), np.stack(ts)
    R0, t0 = R_gt.copy(), t_gt.copy()
    X0 = X + rng.normal(scale=point_noise, size=X.shape).astype(np.float32)
    for k in range(1, K):
        dw = rng.normal(scale=pose_noise, size=3).astype(np.float32)
        dt = rng.normal(scale=pose_noise, size=3).astype(np.float32)
        dR = rot(dw)
        R0[k] = dR @ R_gt[k]
        t0[k] = dR @ t_gt[k] + dt
    cam_fixed = np.zeros(K, bool)
    cam_fixed[0] = True
    prob, _ = make_problem(
        R=R0, t=t0, X=X0,
        cam=np.repeat(np.arange(K, dtype=np.int32), P),
        pnt=np.tile(np.arange(P, dtype=np.int32), K),
        uv=np.concatenate(uvs).astype(np.float32),
        w=np.ones(K * P, np.float32), intr=INTR, cam_fixed=cam_fixed, device=device,
    )
    return prob, (R_gt, t_gt, X)


def multihost_problem(K: int = 4, n_pts: int = 64, noise: float = 0.03, seed: int = 0,
                      device="cuda"):
    """The deterministic BA problem of the multi-process test (port of
    scripts/multihost_ba_worker.py:synthetic_problem, the same draws of
    `np.random.RandomState(seed)`): K cameras translating along x, every
    camera seeing every point, camera 0 exact and fixed. Returns the
    BAProblem on `device`."""
    rng = np.random.RandomState(seed)
    X_gt = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    X_gt[:, 2] += 4.0
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.stack([np.array([0.4 * k, 0.05 * k, 0.0], np.float32) for k in range(K)])
    intr = np.array([480.0, 480.0, 320.0, 240.0], np.float32)
    cam = np.repeat(np.arange(K), n_pts).astype(np.int32)
    pnt = np.tile(np.arange(n_pts), K).astype(np.int32)
    Xc = (np.einsum("kij,nj->kni", R, X_gt) + t[:, None, :]).reshape(-1, 3)
    uv = np.stack([intr[0] * Xc[:, 0] / Xc[:, 2] + intr[2],
                   intr[1] * Xc[:, 1] / Xc[:, 2] + intr[3]], -1).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    X0 = X_gt + rng.normal(0, noise, X_gt.shape).astype(np.float32)
    cam_fixed = np.zeros(K, bool)
    cam_fixed[0] = True
    t0 = t + rng.normal(0, 0.01, t.shape).astype(np.float32)
    t0[0] = t[0]
    prob, _ = make_problem(R=R, t=t0, X=X0, cam=cam, pnt=pnt, uv=uv, w=np.ones(len(cam), np.float32),
                           intr=intr, cam_fixed=cam_fixed, device=device)
    return prob


def big_pose_graph(K: int = 5000, device="cuda"):
    """A K-keyframe noisy pose chain with long-range loop edges, the graph
    of the JAX package's 5k pose-graph tests: the draws of
    `np.random.default_rng(3)` in `make_big_graph`'s order, rotations from
    this package's so3_exp. Returns (PoseGraph on `device`, (R_gt, t_gt)
    as NumPy)."""
    from ..models import pose_graph as pg

    rs = np.random.default_rng(3)

    def so3(w):
        return lie.so3_exp(torch.from_numpy(np.stack(w))).numpy()

    steps = []
    for _ in range(1, K):
        w = rs.normal(scale=0.02, size=3).astype(np.float32)
        steps.append((w, rs.normal(scale=0.1, size=3)))
    dR = so3([w for w, _ in steps])
    R_gt = [np.eye(3, dtype=np.float32)]
    t_gt = [np.zeros(3, np.float32)]
    for k, (_, dt) in enumerate(steps):
        R_gt.append((dR[k] @ R_gt[-1]).astype(np.float32))
        t_gt.append((dR[k] @ t_gt[-1] + dt).astype(np.float32))
    R_gt, t_gt = np.stack(R_gt), np.stack(t_gt)
    noise = []
    for _ in range(1, K):
        dw = rs.normal(scale=0.02, size=3).astype(np.float32)
        noise.append((dw, rs.normal(scale=0.02, size=3).astype(np.float32)))
    R0, t0 = R_gt.copy(), t_gt.copy()
    R0[1:] = so3([dw for dw, _ in noise]) @ R_gt[1:]
    t0[1:] = t_gt[1:] + np.stack([dt for _, dt in noise])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    g = pg.from_keyframe_chain(dev(R_gt), dev(t_gt), torch.ones(K, dtype=torch.bool, device=device))
    g = g._replace(R=dev(R0), t=dev(t0))
    li = np.arange(0, K - 1000, 500)
    lj = li + 1000
    Z_R, Z_t = pg._rel(dev(R_gt), dev(t_gt), li, lj)
    g = pg.add_edges(g, li.astype(np.int32), lj.astype(np.int32), Z_R, Z_t,
                     np.full(len(li), 5.0, np.float32))
    return g, (R_gt, t_gt)


def _yaw(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _look_at(center, target):
    """world->cam rotation for a camera at `center` looking at `target`."""
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(z, np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z]).astype(np.float32)


def _project(R, t, X, intr):
    Xc = X @ R.T + t
    z = np.maximum(Xc[:, 2], 1e-6)
    u = intr[0] * Xc[:, 0] / z + intr[2]
    v = intr[1] * Xc[:, 1] / z + intr[3]
    return np.stack([u, v], -1).astype(np.float32), Xc[:, 2]


class RingScene:
    """K keyframes on a circle looking in at a point cloud, loaded into a
    monocular Slam on `device`, with a smoothly accumulating world-side Sim3
    drift D_k (scale s_k, yaw th_k, offset d_k; identity at k = 0): the
    estimated pose is R_est = R_gt R_d(th)^T, t_est = s_k t_gt - R_est d_k,
    and a landmark anchored at keyframe a sits at D_a(X_gt). Observations are
    exact projections from keyframes within `obs_span` of the landmark's
    home. The self-consistent but drifted geometry of monocular SLAM; the
    closure between the last keyframe and the first is the loop to close.
    Draws from `rng` come in the order of the JAX package's test scene, so
    both build the same map."""

    def __init__(self, rng: np.random.Generator, K: int = 40, n_pts: int = 350,
                 drift_scale: float = 1.15, drift_yaw_deg: float = 0.0, obs_span: int = 2,
                 device="cuda"):
        from ..config import MapConfig, SlamConfig
        from ..pipeline import FrameResult, Slam

        cfg = SlamConfig()
        cfg.map = MapConfig(max_keyframes=max(64, K), max_points=2048, max_observations=16384,
                            track_capacity=512)
        cfg.use_depth = False
        self.cfg, self.K, self.intr = cfg, K, cfg.intrinsics
        ang = np.linspace(0, 2 * np.pi * (K - 1) / K, K)
        centers = np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang), 0.2 * np.sin(2 * ang)],
                           -1).astype(np.float32)
        self.R_gt = np.stack([_look_at(c, np.zeros(3)) for c in centers])
        self.t_gt = -np.einsum("kij,kj->ki", self.R_gt, centers).astype(np.float32)
        frac = np.linspace(0, 1, K).astype(np.float32)
        self.s_d = (1.0 + (drift_scale - 1.0) * frac).astype(np.float32)
        self.th_d = np.deg2rad(drift_yaw_deg) * frac
        self.d_d = np.stack([0.3 * frac, -0.2 * frac, 0.1 * frac], -1).astype(np.float32)
        self.R_est = np.stack([self.R_gt[k] @ _yaw(self.th_d[k]).T for k in range(K)])
        self.t_est = np.stack([self.s_d[k] * self.t_gt[k] - self.R_est[k] @ self.d_d[k]
                               for k in range(K)]).astype(np.float32)
        self.X_gt = rng.uniform(-0.9, 0.9, (n_pts, 3)).astype(np.float32)
        home = rng.integers(0, K, n_pts)
        self.slam = Slam(cfg, device=device)
        m = self.slam.map
        for k in range(K):
            m.add_keyframe(self.R_est[k], self.t_est[k], k * 10)
            self.slam.trajectory.append(FrameResult(
                k * 10, self.R_est[k].copy(), self.t_est[k].copy(), 100, True, ref_kf=k))
        self.pt_ids = np.zeros(n_pts, np.int64)
        desc = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32).view(np.int32)
        for k in range(K):
            sel = np.where(home == k)[0]
            if len(sel):
                self.pt_ids[sel] = m.add_points(self._drifted(self.X_gt[sel], k), desc[sel])
        for k in range(K):
            # Observations in keyframe order, so anchors are first observers.
            vis = np.where(np.minimum(np.abs(home - k), K - np.abs(home - k)) <= obs_span)[0]
            uv, z = _project(self.R_est[k], self.t_est[k], m.pt_xyz[self.pt_ids[vis]], self.intr)
            ok = z > 0.1
            m.add_observations(k, self.pt_ids[vis[ok]], uv[ok])
        m.refresh_scale_meas()
        self.slam._last_kf_id = K - 1
        self.slam.initialized = True
        self.slam.stats["keyframes"] = K
        self.home = home

    def _drifted(self, X, k):
        return (self.s_d[k] * (X @ _yaw(self.th_d[k]).T) + self.d_d[k]).astype(np.float32)

    def endpoint_error(self) -> float:
        """Camera-centre error of the last keyframe against ground truth."""
        m = self.slam.map
        k = self.K - 1
        return float(np.linalg.norm(-m.kf_R[k].T @ m.kf_t[k] + self.R_gt[k].T @ self.t_gt[k]))

    def verify_handle(self, cur: int, cand: int, n_inl: int, true_pose: bool = True) -> dict:
        """The input of Slam._close_loop: the verification of `cur`'s
        features against `cand`'s landmark snapshot, as the tracking step
        would return it, with n_inl inliers. true_pose: the pose of `cur` in
        the candidate's drift frame (a genuine revisit); else the
        candidate's own pose (repetitive texture matched as if `cur` stood
        at `cand`)."""
        m, dev = self.slam.map, self.slam.device
        snap = m.local_snapshot(cand, dev)
        M, F = self.cfg.map.track_capacity, self.cfg.frontend.max_features
        slots = np.where(snap["valid"].cpu().numpy())[0][:n_inl]
        if len(slots) < n_inl:
            raise ValueError("the scene is too sparse for the requested inliers")
        if true_pose:
            R_corr = (self.R_gt[cur] @ _yaw(self.th_d[cand]).T).astype(np.float32)
            t_corr = (self.s_d[cand] * self.t_gt[cur] - R_corr @ self.d_d[cand]).astype(np.float32)
        else:
            R_corr, t_corr = m.kf_R[cand].copy(), m.kf_t[cand].copy()
        uvs, _ = _project(R_corr, t_corr, snap["xyz"].cpu().numpy()[slots], self.intr)
        inliers = np.zeros(M, bool)
        inliers[slots] = True
        idx2 = np.zeros(M, np.int64)
        idx2[slots] = np.arange(n_inl)  # feature i of cur matches slot i
        uv = np.zeros((F, 2), np.float32)
        uv[:n_inl] = uvs
        valid = np.zeros(F, bool)
        valid[:n_inl] = True
        from ..pipeline import TrackStep

        def dev_(a):
            return torch.from_numpy(a).to(dev)

        step = TrackStep(R=dev_(R_corr), t=dev_(t_corr), inliers=dev_(inliers),
                         n_inliers=torch.tensor(n_inl, device=dev), idx2=dev_(idx2),
                         used_ransac=False)
        feats = Features(uv=dev_(uv), desc=torch.zeros((F, 8), dtype=torch.int32, device=dev),
                         score=torch.zeros(F, dtype=torch.float32, device=dev), valid=dev_(valid))
        return dict(kf_id=cur, cand=cand, feats=feats, snap=snap, step=step)
