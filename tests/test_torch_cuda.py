"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA card and skips without one; this
file imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from torch_parity import (RAGGED_SIZES, cam_reduce_walk, checkerboard, desc_bits, edge_keypoints,
                          exact_reduce, smooth_noise, uniform_noise)

from visual_slam_tpu_torch import convert
from visual_slam_tpu_torch.config import SlamConfig
from visual_slam_tpu_torch.models import frontend
from visual_slam_tpu_torch.models import ba, ba_large, loop_closure, pose_graph
from visual_slam_tpu_torch.ops.kernels import build, detect_kernel, patch_kernel, seg_kernel
from visual_slam_tpu_torch.pipeline import Slam, run_pipelined, run_sequence
from visual_slam_tpu_torch.utils import synthetic
from visual_slam_tpu_torch.utils.evaluate import ate_rmse
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

pytestmark = pytest.mark.cuda

PEAK_RTOL = 1e-5  # front-end score, card vs CPU (B1 itself is bit-equal to plain)
MIN_DESC_BIT_AGREEMENT = 0.995  # card vs CPU: matmul sums in another order
POSE_ATOL = 1e-4
# B4 against index_add_, which adds in another order: the JAX package's bar
# between its reduce kernel and its XLA version
# (tests/test_pallas_kernels.py:46-48). Against its own order of additions
# (torch_parity.cam_reduce_walk) B4 is bit-equal.
REDUCE_RTOL, REDUCE_ATOL = 1e-5, 1e-4
# BA on the card vs on the CPU: f32 camera sums associate differently and LM
# accept/reject rounds amplify it (the JAX package's sharded-identity bars,
# tests/test_ba_large.py:41-46).
BA_COST_RTOL, BA_T_ATOL, BA_X_ATOL = 1e-2, 1e-3, 1e-3
# Sim3 ATE of the monocular run at 320x240, every 3rd frame: the JAX
# package's Slam gets 0.0215 m; the port 0.0257 m on the CPU and 0.0197-
# 0.0290 m in three runs on an H100 (0.0331 m with B4's reduce done on the
# host instead).
MONO_ATE_LIMIT_M = 0.05


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


DETECT_IMAGES = {
    "noise_480x640": lambda: smooth_noise(480, 640),
    "checker_480x640": checkerboard,
    **{f"raw_{h}x{w}": (lambda h=h, w=w: uniform_noise(h, w, seed=h + w)) for h, w in RAGGED_SIZES},
}


@pytest.mark.parametrize("border", [16, 0])
@pytest.mark.parametrize("name", sorted(DETECT_IMAGES))
def test_detect_blur_matches_plain(cuda, name, border):
    """B1 and its B2 mode vs the plain version, both on the card: bit-equal
    peaks (-inf included) and blur, at 480x640 and at ragged sizes, with the
    16 px border frame and with none."""
    img = torch.from_numpy(DETECT_IMAGES[name]()).to(cuda)
    n0, n2 = detect_kernel.launches, detect_kernel.launches_no_blur
    pk, bk = detect_kernel.corner_peaks_and_blur(img, border=border)
    p2 = detect_kernel.corner_peaks(img, border=border)
    pp, bp = detect_kernel.corner_peaks_and_blur_torch(img, border=border)
    torch.cuda.synchronize()
    assert (detect_kernel.launches, detect_kernel.launches_no_blur) == (n0 + 1, n2 + 1)
    assert torch.equal(pk, pp) and torch.equal(bk, bp)
    assert torch.equal(p2, pk) and torch.equal(p2, detect_kernel.corner_peaks_torch(img, border=border))
    if min(img.shape) <= 2 * border:
        assert not torch.isfinite(pk).any()


def test_detect_sqrt_matches_ieee(cuda):
    """B1's branch-free square root equals CUDA's IEEE sqrt on every float
    from +0 to +inf (the check runs on the card)."""
    assert detect_kernel.sqrt_check(cuda) == (0, 0xFFFFFFFF)


def test_patch_matches_plain(cuda):
    """B3 is bit-exact, including keypoints that clamp at every edge."""
    img = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (480, 640)).astype(np.float32)).to(cuda)
    uv = torch.from_numpy(edge_keypoints(480, 640, 1024)).to(cuda)
    n0 = patch_kernel.launches
    got = patch_kernel.extract_patches(img, uv)
    want = patch_kernel.extract_patches_torch(img, uv)
    assert patch_kernel.launches == n0 + 1
    assert torch.equal(got, want)


def test_wrappers_raise_instead_of_falling_back(cuda):
    """A CUDA tensor the kernel does not take raises; nothing falls back."""
    with pytest.raises(ValueError):
        detect_kernel.corner_peaks_and_blur(torch.zeros((64, 64), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        detect_kernel.corner_peaks_and_blur(torch.zeros((64, 64), device=cuda), nms_radius=2)
    with pytest.raises(ValueError):
        patch_kernel.extract_patches(torch.zeros((64, 64), device=cuda), torch.zeros((4, 2)))


def test_frontend_card_matches_cpu(cuda):
    img = torch.from_numpy(smooth_noise(480, 640, seed=4))
    fg = frontend.extract(img.to(cuda), 1024)
    fc = frontend.extract(img, 1024)
    assert torch.equal(fg.uv.cpu(), fc.uv) and torch.equal(fg.valid.cpu(), fc.valid)
    torch.testing.assert_close(fg.score.cpu(), fc.score, rtol=PEAK_RTOL, atol=0)
    v = fc.valid.numpy()
    agree = desc_bits(convert.to_jax_desc(fg.desc))[v] == desc_bits(convert.to_jax_desc(fc.desc))[v]
    assert agree.mean() >= MIN_DESC_BIT_AGREEMENT


def test_slice_card_matches_cpu(cuda):
    """8 frames of the RGB-D slice on the card and on the CPU agree."""
    intr = np.array([240.6, 240.0, 159.75, 119.75], np.float32)
    scene = SyntheticRGBDScene(8, 240, 320, intrinsics=intr)
    runs = []
    for device in (cuda, "cpu"):
        cfg = SlamConfig(use_depth=True, intrinsics=intr)
        cfg.frontend.max_features = 256
        cfg.map.track_capacity = 512
        runs.append(run_sequence(scene, cfg, device=device))
    for fg, fc in zip(runs[0].trajectory, runs[1].trajectory):
        np.testing.assert_allclose(fg.R_cw, fc.R_cw, atol=POSE_ATOL)
        np.testing.assert_allclose(fg.t_cw, fc.t_cw, atol=POSE_ATOL)
        assert abs(fg.n_tracked - fc.n_tracked) <= 2
    assert runs[0].stats == runs[1].stats


@pytest.mark.parametrize("mode", ["rgbd", "mono"])
def test_slam_card_matches_cpu(cuda, mode):
    """The whole SLAM loop at 320x240 (K=256, M=512) on the card and on the
    CPU: RGB-D over 60 frames, monocular on every 3rd of 178.

    RGB-D: init, keyframe and BA-apply frames agree, camera centres to
    BA_T_ATOL. Monocular: the same holds, centres to POSE_ATOL, up to the
    frame where the second BA applies. That BA (three keyframes, two free)
    is chaotic in float32: the card's and the CPU's camera sums, added in
    different orders, part the runs after it (PERF.md), so from there on
    each run is held to the same bars: keyframe count, BA count within one,
    no track failure, Sim3 ATE under MONO_ATE_LIMIT_M."""
    intr = np.array([240.6, 240.0, 159.75, 119.75], np.float32)
    n_frames, stride = (60, 1) if mode == "rgbd" else (178, 3)
    scene = SyntheticRGBDScene(n_frames, 240, 320, intrinsics=intr)
    frames = [(i, *scene.render(i)) for i in range(0, n_frames, stride)]
    runs = []
    for device in (cuda, "cpu"):
        cfg = SlamConfig(use_depth=mode == "rgbd", intrinsics=intr)
        cfg.frontend.max_features = 256
        cfg.map.track_capacity = 512
        slam = Slam(cfg, device=device)
        applied = []
        for i, gray, depth in frames:
            slam.process(i, gray, depth if mode == "rgbd" else None)
            applied.append(slam.stats["ba_runs"])
        runs.append((slam, applied))
    (sg, ag), (sc, ac) = runs
    assert sg.stats["init_frame"] == sc.stats["init_frame"]
    assert ac[-1] >= 2
    # Monocular: poses agree before the second BA applies, decisions up to
    # and including that frame.
    n_pose = ac.index(2) if mode == "mono" else len(frames)
    n_same = min(n_pose + 1, len(frames))
    last = frames[n_same - 1][0]
    assert ag[:n_same] == ac[:n_same]
    kf_g, kf_c = ([f.frame_idx for f in s.trajectory if f.is_keyframe] for s in (sg, sc))
    assert [k for k in kf_g if k <= last] == [k for k in kf_c if k <= last]
    posed = {i for i, *_ in frames[:n_pose]}
    tg, tc = ([f for f in s.trajectory if f.frame_idx in posed] for s in (sg, sc))
    atol = BA_T_ATOL if mode == "rgbd" else POSE_ATOL
    for fg, fc in zip(tg, tc, strict=True):
        assert fg.frame_idx == fc.frame_idx
        np.testing.assert_allclose(-fg.R_cw.T @ fg.t_cw, -fc.R_cw.T @ fc.t_cw, atol=atol)
    if mode == "mono":
        assert len(kf_g) == len(kf_c) and abs(ag[-1] - ac[-1]) <= 1
        for s in (sg, sc):
            idxs, est = s.positions()
            ate, _ = ate_rmse(est, scene.ground_truth()[idxs, :3, 3], align_scale=True)
            assert s.stats["track_failures"] == 0 and ate < MONO_ATE_LIMIT_M


def test_slam_card_runs_repeat(cuda):
    """The monocular loop of test_slam_card_matches_cpu[mono] twice on the
    card: the same trajectory, bit for bit, and the same BA history. B4
    adds in an order fixed by its plan, so nothing in the loop depends on
    the run."""
    intr = np.array([240.6, 240.0, 159.75, 119.75], np.float32)
    scene = SyntheticRGBDScene(178, 240, 320, intrinsics=intr)
    frames = [(i, scene.render(i)[0]) for i in range(0, 178, 3)]
    runs = []
    for _ in range(2):
        cfg = SlamConfig(intrinsics=intr)
        cfg.frontend.max_features = 256
        cfg.map.track_capacity = 512
        slam = Slam(cfg, device=cuda)
        history = []
        for i, gray in frames:
            slam.process(i, gray)
            history.append((slam.stats["ba_runs"], slam.stats["ba_rejected"],
                            slam.stats["ba_dropped_stale"], slam.stats["keyframes"]))
        runs.append((slam, history))
    (sa, ha), (sb, hb) = runs
    assert ha == hb and sa.stats == sb.stats and sa.stats["ba_runs"] >= 2
    assert len(sa.trajectory) == len(sb.trajectory)
    for fa, fb in zip(sa.trajectory, sb.trajectory):
        assert (fa.frame_idx, fa.is_keyframe) == (fb.frame_idx, fb.is_keyframe)
        assert np.array_equal(fa.R_cw, fb.R_cw) and np.array_equal(fa.t_cw, fb.t_cw)
    assert np.array_equal(sa.map.pt_xyz, sb.map.pt_xyz)


@pytest.mark.parametrize("mode", ["rgbd", "mono"])
def test_pipelined_card_matches_cpu_and_repeats(cuda, mode):
    """run_pipelined (depth 8) over the scenes of test_slam_card_matches_cpu,
    twice on the card and once on the CPU. The two card runs: the same
    trajectory, stats and map, bit for bit (every decision of the driver is
    a count). Card against CPU: RGB-D, the same history and stats, centres
    within BA_T_ATOL; monocular, the same init frame, re-anchors and
    trajectory frames, and each run's health bars. Frames posed by
    PnP-RANSAC take the device generator's draws (the CPU's differ), so the
    monocular poses are not compared."""
    intr = np.array([240.6, 240.0, 159.75, 119.75], np.float32)
    n_frames, stride = (60, 1) if mode == "rgbd" else (178, 3)
    scene = SyntheticRGBDScene(n_frames, 240, 320, intrinsics=intr)
    frames = [(i, *scene.render(i)) for i in range(0, n_frames, stride)]
    if mode == "mono":
        frames = [(i, gray, None) for i, gray, _ in frames]
    runs = []
    for device in (cuda, cuda, "cpu"):
        cfg = SlamConfig(use_depth=mode == "rgbd", intrinsics=intr)
        cfg.frontend.max_features = 256
        cfg.map.track_capacity = 512
        runs.append(run_pipelined(Slam(cfg, device=device), iter(frames), 8))
    sa, sb, sc = runs
    assert sa.stats == sb.stats and len(sa.trajectory) == len(sb.trajectory)
    for fa, fb in zip(sa.trajectory, sb.trajectory):
        assert (fa.frame_idx, fa.is_keyframe, fa.n_tracked) == (fb.frame_idx, fb.is_keyframe, fb.n_tracked)
        assert np.array_equal(fa.R_cw, fb.R_cw) and np.array_equal(fa.t_cw, fb.t_cw)
    assert np.array_equal(sa.map.pt_xyz, sb.map.pt_xyz)
    assert sa.stats["init_frame"] == sc.stats["init_frame"]
    assert sa.stats["init_reanchors"] == sc.stats["init_reanchors"]
    assert [f.frame_idx for f in sa.trajectory] == [f.frame_idx for f in sc.trajectory]
    for s in (sa, sc):
        idxs, est = s.positions()
        ate, _ = ate_rmse(est, scene.ground_truth()[idxs, :3, 3], align_scale=mode == "mono")
        assert s.stats["track_failures"] == 0 and ate < (0.02 if mode == "rgbd" else 0.1)
    if mode == "rgbd":
        assert sa.stats == sc.stats and sa.stats["ba_runs"] >= 2
        for fa, fc in zip(sa.trajectory, sc.trajectory):
            assert fa.is_keyframe == fc.is_keyframe
            np.testing.assert_allclose(-fa.R_cw.T @ fa.t_cw, -fc.R_cw.T @ fc.t_cw, atol=BA_T_ATOL)


@pytest.mark.parametrize("C,N,K,case", [
    (27, 1 << 22, 5000, "config5"),  # the build's reduce at BASELINE.json config #5
    (12, 1 << 22, 5000, "config5"),  # the projection's expand there
    (5, 100003, 257, "ragged"),  # N a multiple of no block; ids >= K and < 0
    (27, 1 << 20, 5000, "hot"),  # 90% of the slots on 3 cameras
    (42, 16384, 64, "kfba"),  # the keyframe BA's U/g_c reduce: padding on camera 0
    (3, 50000, 100000, "wide"),  # K larger than N
])
def test_seg_kernels_match_plain(cuda, C, N, K, case):
    """B4 and B5 against their plain versions; B4 bit-equal to its own
    order of additions and, on dyadic rows (exact sums), to index_add_, and
    the same bits on ten calls. Against float64 sums B4 stays within the
    bound of any float32 order; where thousands of slots share a camera
    (hot, kfba), index_add_'s own float32 sums drift past rtol 1e-5 / atol
    1e-4 of the float64 ones, so there B4 is held no farther off than a
    sum in slot order (index_add_ on the CPU), elsewhere within rtol / atol
    of index_add_."""
    rng = np.random.default_rng(C + K)
    cam = rng.integers(0, K, N).astype(np.int32)
    data = rng.normal(size=(C, N)).astype(np.float32)
    if case == "ragged":
        cam[::7], cam[::11] = K + 3, -1
    if case == "hot":
        hot = rng.uniform(size=N) < 0.9
        cam[hot] = np.array([7, 1234, K - 1], np.int32)[rng.integers(0, 3, int(hot.sum()))]
    if case == "kfba":  # make_problem's layout: Q=8 slots a landmark, 7 of them padding
        cam = cam.reshape(-1, 8)
        cam[:, 1:] = 0
        cam = np.ascontiguousarray(cam.reshape(-1))
    dyadic = (rng.integers(-1024, 1024, (C, N)) / 256).astype(np.float32)  # exact sums
    d, c, dd = (torch.from_numpy(a).to(cuda) for a in (data, cam, dyadic))
    x = torch.from_numpy(rng.normal(size=(C, K)).astype(np.float32)).to(cuda)
    n_red, n_exp = seg_kernel.reduce_launches, seg_kernel.expand_launches
    red = seg_kernel.cam_reduce(d, c, K)
    exp = seg_kernel.cam_expand(x, c)
    assert (seg_kernel.reduce_launches, seg_kernel.expand_launches) == (n_red + 1, n_exp + 1)
    exact, bound = exact_reduce(d, c, K)
    err = (red.double() - exact).abs()
    assert (err <= bound).all()
    if case in ("hot", "kfba"):  # 1e4-1e5 normal terms a camera
        seq = seg_kernel.cam_reduce_torch(torch.from_numpy(data), torch.from_numpy(cam), K)
        assert err.max().item() <= (seq.double() - exact.cpu()).abs().max().item()
    else:
        torch.testing.assert_close(red, seg_kernel.cam_reduce_torch(d, c, K),
                                   rtol=REDUCE_RTOL, atol=REDUCE_ATOL)
    plan = seg_kernel.reduce_plan(c, K)
    assert torch.equal(red, cam_reduce_walk(d, plan))
    assert all(torch.equal(seg_kernel.cam_reduce(d, c, K, plan), red) for _ in range(10))
    assert torch.equal(seg_kernel.cam_reduce(dd, c, K, plan), seg_kernel.cam_reduce_torch(dd, c, K))
    assert torch.equal(exp, seg_kernel.cam_expand_torch(x, c))


@pytest.mark.parametrize("C,N,K,case,chunks", [
    (12, 1 << 22, 5000, "uniform", 1),  # config #5's projection
    (6, 1 << 22, 5000, "uniform", 1),  # its matvec
    (12, 16384, 64, "kfba", 6),  # the keyframe BA: padding slots on camera 0, 6 chunks of 2
    (5, 100003, 257, "ragged", 1),  # N % 4 != 0; ids >= K and < 0
    (7, 4098, 300, "ragged", 7),  # N % 4 == 2
    (4, 3, 9, "ragged", 4),  # N < 4
    (1, 1000, 1, "uniform", 1),  # C = 1, K = 1
    (3, 50000, 100000, "ragged", 2),  # a 1.2 MB table, past L1
])
def test_expand_matches_plain(cuda, C, N, K, case, chunks):
    """B5 bit for bit against its plain version, one launch a call, in the
    geometry expand_geometry picks and in others at the same shape: one
    channel a chunk, all channels in one, 512-thread blocks, an odd grid of
    96-thread blocks, scalar ids and stores, the other store hint. The
    table holds -0.0, inf, NaN and subnormals, compared as bits; ids from an
    offset the 16-byte path cannot take go the scalar way."""
    rng = np.random.default_rng(C + N + K)
    cam = rng.integers(0, K, N + 1).astype(np.int32)
    if case == "ragged":
        cam[::7], cam[::11], cam[::13] = K + 3, -1, K
    if case == "kfba":  # make_problem's layout: Q=8 slots a landmark, 7 of them padding
        cam[:N].reshape(-1, 8)[:, 1:] = 0
    x = rng.normal(size=(C, K)).astype(np.float32)
    x.ravel()[:4] = [-0.0, np.inf, np.nan, 1e-40][:x.size]
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(cam).to(cuda)
    c = ct[:N]
    sms, l2 = seg_kernel._card(cuda.index or 0)
    g = seg_kernel.expand_geometry(C, N, sms, l2, c.data_ptr() % 16 == 0)
    assert g.chunks == chunks and g.vec4 == (N % 4 == 0)
    want = seg_kernel.cam_expand_torch(xt, c).view(torch.int32)
    n0 = seg_kernel.expand_launches
    got = seg_kernel.cam_expand(xt, c)
    torch.cuda.synchronize()
    assert seg_kernel.expand_launches == n0 + 1
    assert torch.equal(got.view(torch.int32), want)
    variants = [g._replace(ck=1, chunks=C), g._replace(ck=C, chunks=1),
                g._replace(threads=512, grid_x=2 * sms), g._replace(threads=96, grid_x=7),
                g._replace(vec4=False), g._replace(evict_first=not g.evict_first)]
    lib = build.library()
    for v in variants:
        assert torch.equal(seg_kernel._launch_expand(lib, xt, c, v).view(torch.int32), want), v
    if N > 1:  # ids one int past a 16-byte boundary
        assert torch.equal(seg_kernel.cam_expand(xt, ct[1:N + 1]).view(torch.int32),
                           seg_kernel.cam_expand_torch(xt, ct[1:N + 1]).view(torch.int32))
    assert seg_kernel.expand_launches == n0 + 1 + (N > 1)


def test_expand_refuses_a_geometry_it_cannot_take(cuda):
    """A geometry the kernel does not take is refused at launch, and the
    launch raises: no channels a chunk, no blocks, an odd or oversized
    block, 16-byte ids at an unaligned offset."""
    cam = torch.zeros(4097, dtype=torch.int32, device=cuda)
    x = torch.zeros((3, 100), device=cuda)
    sms, l2 = seg_kernel._card(cuda.index or 0)
    g = seg_kernel.expand_geometry(3, 4096, sms, l2)
    lib = build.library()
    for bad in (g._replace(ck=0), g._replace(grid_x=0), g._replace(threads=48),
                g._replace(threads=2048)):
        with pytest.raises(RuntimeError):
            seg_kernel._launch_expand(lib, x, cam[:4096], bad)
    with pytest.raises(RuntimeError):
        seg_kernel._launch_expand(lib, x, cam[1:], g)


def test_seg_wrappers_raise_instead_of_falling_back(cuda):
    cam = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        seg_kernel.cam_reduce(torch.zeros((3, 10), dtype=torch.float64, device=cuda), cam, 4)
    with pytest.raises(ValueError):
        seg_kernel.cam_reduce(torch.zeros((3, 10), device=cuda), cam.long(), 4)
    with pytest.raises(ValueError):
        seg_kernel.cam_reduce(torch.zeros((10, 3), device=cuda).T, cam, 4)
    with pytest.raises(ValueError):
        seg_kernel.cam_expand(torch.zeros((3, 4), device=cuda), cam.cpu())
    with pytest.raises(ValueError):  # a plan made for other ids
        seg_kernel.cam_reduce(torch.zeros((3, 10), device=cuda), cam, 4,
                              seg_kernel.reduce_plan(cam[:9], 4))


def test_ba_large_card_matches_cpu(cuda):
    prob, gt = synthetic.build_loop_map(64, 2048, 4, device="cpu")
    n_red, n_exp = seg_kernel.reduce_launches, seg_kernel.expand_launches
    og, cg = ba_large.optimize(ba.BAProblem(*(f.to(cuda) for f in prob)), n_iters=5, cg_iters=8,
                               init_lambda=1e-2)
    oc, cc = ba_large.optimize(prob, n_iters=5, cg_iters=8, init_lambda=1e-2)
    assert seg_kernel.reduce_launches - n_red == 5 * (8 + 2)
    assert seg_kernel.expand_launches - n_exp == 1 + 5 * (8 + 3)
    assert abs(float(cg) - float(cc)) < BA_COST_RTOL * float(cc)
    np.testing.assert_allclose(og.t.cpu().numpy(), oc.t.numpy(), atol=BA_T_ATOL)
    np.testing.assert_allclose(og.X.cpu().numpy(), oc.X.numpy(), atol=BA_X_ATOL)


@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_online_ba_card_matches_cpu(cuda, solver):
    runs = []
    for device in (cuda, "cpu"):
        prob, _ = synthetic.arc_problem(6, 300, 0.3, 0.03, 0.05, seed=0, device=device)
        runs.append(ba.optimize(prob, n_iters=6, cg_iters=10, solver=solver))
    (og, cg), (oc, cc) = runs
    assert abs(float(cg) - float(cc)) < BA_COST_RTOL * float(cc)
    # Monocular scale is a gauge freedom here: compare scale-aligned.
    s = np.linalg.norm(og.t[1].cpu().numpy()) / np.linalg.norm(oc.t[1].numpy())
    np.testing.assert_allclose(og.t.cpu().numpy() / s, oc.t.numpy(), atol=BA_T_ATOL)


# Pose graph on the card: B4 adds in another order than index_add_; 25 GN
# steps carry the difference (the chip_smoke.py phase-17 bars).
PG_R_ATOL, PG_T_ATOL, PG_LAM_ATOL = 1e-4, 1e-3, 1e-4


def _pose_graphs():
    """A 200-keyframe chain with loop edges (big_pose_graph's draws), and its
    Sim3 graph, on the CPU."""
    g, _ = synthetic.big_pose_graph(200, device="cpu")
    g = pose_graph.add_edges(g, np.array([0, 50], np.int32), np.array([150, 199], np.int32),
                             g.Z_R[:2], g.Z_t[:2] * 3.0, np.array([50.0, 5.0], np.float32))
    z = torch.zeros_like
    s3 = pose_graph.Sim3Graph(R=g.R, t=g.t, lam=z(g.t[:, 0]), e_i=g.e_i, e_j=g.e_j, Z_R=g.Z_R,
                              Z_t=g.Z_t, Z_ls=z(g.w), w=g.w, w_lam=g.w, fixed=g.fixed)
    return [(pose_graph.optimize, g), (pose_graph.optimize_sim3, s3)]


def _to(g, device):
    return type(g)(*(a.to(device) for a in g))


@pytest.mark.parametrize("which", [0, 1], ids=["se3", "sim3"])
def test_pose_graph_kernels_match_plain(cuda, which, monkeypatch):
    """optimize / optimize_sim3 on the card through B4/B5 against the same
    solve on the card through their plain versions, and against the CPU:
    within the bars; B4 and B5 launched n_iters x (1 + cg_iters) times a
    call each."""
    fn, g = _pose_graphs()[which]
    gd = _to(g, cuda)
    n_red, n_exp = seg_kernel.reduce_launches, seg_kernel.expand_launches
    out = fn(gd, n_iters=6, cg_iters=20)
    assert (seg_kernel.reduce_launches - n_red, seg_kernel.expand_launches - n_exp) == (6 * 21, 6 * 21)
    monkeypatch.setattr(seg_kernel, "cam_reduce", lambda d, c, K, plan=None: seg_kernel.cam_reduce_torch(d, c, K))
    monkeypatch.setattr(seg_kernel, "cam_expand", seg_kernel.cam_expand_torch)
    plain = fn(gd, n_iters=6, cg_iters=20)
    monkeypatch.undo()
    cpu = fn(g, n_iters=6, cg_iters=20)
    for other in (plain, cpu):
        for a, b, bar in zip(out[:-1], other[:-1], (PG_R_ATOL, PG_T_ATOL, PG_LAM_ATOL)):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=bar)
        assert abs(float(out[-1]) - float(other[-1])) <= 1e-3 * abs(float(other[-1])) + 1e-6


@pytest.mark.parametrize("which", [0, 1], ids=["se3", "sim3"])
def test_pose_graph_card_runs_repeat(cuda, which):
    """Two card solves of one graph: bit-equal (B4 adds in its plan's order,
    no float atomics)."""
    fn, g = _pose_graphs()[which]
    gd = _to(g, cuda)
    a, b = fn(gd, n_iters=6, cg_iters=20), fn(gd, n_iters=6, cg_iters=20)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_score_keyframes_card_matches_cpu(cuda):
    """Loop scoring on the card: the CPU's integers, at 40 keyframes x 1024
    features (three chunks of 16)."""
    rng = np.random.default_rng(5)
    K, F = 40, 1024
    db = rng.integers(0, 2**32, (K, F, 8), dtype=np.uint32)
    cur = db[3].copy()
    cur[:, 0] ^= np.uint32(0x0F0F)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (cur.view(np.int32), rng.uniform(size=F) < 0.9, db.view(np.int32),
             rng.uniform(size=(K, F)) < 0.9, rng.uniform(size=K) < 0.9)]
    ref = loop_closure.score_keyframes(*args, 48.0)
    got = loop_closure.score_keyframes(*(a.to(cuda) for a in args), 48.0)
    assert torch.equal(got.cpu(), ref) and int(ref.max()) > 500


def test_close_loop_card_matches_cpu(cuda):
    """Slam._close_loop on RingScene (1.15x scale drift, 25 inliers) on the
    card and the CPU: accepted on both, the same record, keyframe poses
    within the pose-graph bars."""
    runs = []
    for device in (cuda, "cpu"):
        sc = synthetic.RingScene(np.random.default_rng(7), device=device)
        sc.slam._close_loop(sc.verify_handle(39, 0, 25))
        runs.append(sc)
    g, c = runs
    assert g.slam.stats["loop_closures"] == c.slam.stats["loop_closures"] == 1
    assert [sorted(d.items()) for d in g.slam.stats["loop_accepted"]] == \
        [sorted(d.items()) for d in c.slam.stats["loop_accepted"]]
    np.testing.assert_allclose(g.slam.map.kf_R, c.slam.map.kf_R, atol=PG_R_ATOL)
    np.testing.assert_allclose(g.slam.map.kf_t, c.slam.map.kf_t, atol=PG_T_ATOL)


BATCH_SIZES = [(480, 640), *RAGGED_SIZES[2:4]]  # 480x640, 45x70, 37x600


@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("hw", BATCH_SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_batched_kernels_match_plain_and_single(cuda, hw, B):
    """B1 (peaks, blur, B2 mode) and B3 on a (B,H,W) stack: one launch
    each, bit-equal to the batched plain version and to B single-image
    launches, at 480x640 and at ragged sizes (tile edges inside every
    image of the stack)."""
    h, w = hw
    border = 16 if min(h, w) > 32 else 0
    imgs = torch.from_numpy(np.stack([uniform_noise(h, w, seed=h + w + s) for s in range(B)])).to(cuda)
    uv = torch.from_numpy(np.stack([edge_keypoints(h, w, 1024, seed=s) for s in range(B)])).to(cuda)
    n1, n3 = detect_kernel.launches, patch_kernel.launches
    pk, bk = detect_kernel.corner_peaks_and_blur(imgs, border=border)
    patches = patch_kernel.extract_patches(imgs, uv)
    assert (detect_kernel.launches, patch_kernel.launches) == (n1 + 1, n3 + 1)
    p2 = detect_kernel.corner_peaks(imgs, border=border)
    pp, bp = detect_kernel.corner_peaks_and_blur_torch(imgs, border=border)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(bk, bp) and torch.equal(p2, pp)
    assert torch.equal(patches, patch_kernel.extract_patches_torch(imgs, uv))
    for b in range(B):
        p1, b1 = detect_kernel.corner_peaks_and_blur(imgs[b], border=border)
        assert torch.equal(pk[b], p1) and torch.equal(bk[b], b1)
        assert torch.equal(patches[b], patch_kernel.extract_patches(imgs[b], uv[b]))


def test_batched_wrappers_raise_instead_of_falling_back(cuda):
    """Stacks the batched kernels do not take raise: CPU/CUDA mixes, wrong
    ranks, keypoints of another batch size, an empty stack."""
    imgs = torch.zeros((2, 64, 64), device=cuda)
    for bad in (torch.zeros((2, 8, 2)), torch.zeros((8, 2), device=cuda),
                torch.zeros((3, 8, 2), device=cuda)):
        with pytest.raises(ValueError):
            patch_kernel.extract_patches(imgs, bad)
    with pytest.raises(ValueError):
        patch_kernel.extract_patches(imgs.cpu(), torch.zeros((2, 8, 2), device=cuda))
    with pytest.raises(ValueError):
        detect_kernel.corner_peaks_and_blur(torch.zeros((1, 2, 64, 64), device=cuda))
    with pytest.raises(ValueError):
        detect_kernel.corner_peaks_and_blur(torch.zeros((0, 64, 64), device=cuda))


def test_extract_batch_card_equals_single_extract(cuda):
    """extract_batch on a (4,480,640) stack on the card: one B1 and one B3
    launch, and each image's features equal to its own extract on the card,
    bit for bit."""
    imgs = torch.from_numpy(np.stack([smooth_noise(480, 640, seed=s) for s in range(3)]
                                     + [checkerboard()])).to(cuda)
    n1, n3 = detect_kernel.launches, patch_kernel.launches
    fb = frontend.extract_batch(imgs, 1024)
    torch.cuda.synchronize()
    assert (detect_kernel.launches, patch_kernel.launches) == (n1 + 1, n3 + 1)
    for b in range(4):
        f = frontend.extract(imgs[b], 1024)
        for name in f._fields:
            assert torch.equal(getattr(fb, name)[b], getattr(f, name)), (b, name)


def test_run_batched_card_equals_run_sequence(cuda):
    """run_batched over two distinct RGB-D windows of the half-size scene
    on the card: each sequence's trajectory, stats and landmarks equal its
    own run_sequence on the card bit for bit."""
    from visual_slam_tpu_torch.multi import run_batched
    from visual_slam_tpu_torch.utils.dataset import WindowView
    from visual_slam_tpu_torch.utils.scene import FrameSequence

    intr = np.array([240.6, 240.0, 159.75, 119.75], np.float32)
    scene = SyntheticRGBDScene(60, 240, 320, intrinsics=intr)
    base = FrameSequence(list(scene.frames()), scene.ground_truth())
    views = [WindowView(base, 0, length=30), WindowView(base, 20, length=30, reverse=True)]
    cfg = SlamConfig(use_depth=True, intrinsics=intr)
    cfg.frontend.max_features = 256
    cfg.map.track_capacity = 512
    slams = run_batched(views, cfg, device=cuda)
    for view, slam in zip(views, slams):
        single = run_sequence(view, cfg, device=cuda)
        assert slam.stats.pop("frontend_devices") == 1
        assert slam.stats == single.stats and slam.stats["ba_runs"] >= 1
        assert len(slam.trajectory) == len(single.trajectory)
        for a, b in zip(slam.trajectory, single.trajectory):
            assert (a.frame_idx, a.is_keyframe, a.n_tracked) == (b.frame_idx, b.is_keyframe, b.n_tracked)
            assert np.array_equal(a.R_cw, b.R_cw) and np.array_equal(a.t_cw, b.t_cw)
        assert np.array_equal(slam.map.pt_xyz, single.map.pt_xyz)


@pytest.fixture(scope="module")
def nccl_world_of_one():
    """An NCCL process group of one rank on the card, in the test process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import torch.distributed as dist
    from visual_slam_tpu_torch.parallel import multihost

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{multihost.free_port()}",
                            world_size=1, rank=0)
    try:
        yield multihost.global_group()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("solver", ["chol", "cg", "large", "pose_graph"])
def test_nccl_world_of_one_is_the_unsharded_solve(nccl_world_of_one, solver):
    """The sharded entry points over an NCCL world of one rank are the
    unsharded solves on the card, bit for bit, with the same B4 and B5
    launches."""
    from visual_slam_tpu_torch.parallel import sharded_ba, sharded_pg

    cuda = torch.device("cuda")
    if solver == "pose_graph":
        g, _ = synthetic.big_pose_graph(2000, device=cuda)
        unsharded = lambda: pose_graph.optimize(g, n_iters=4, cg_iters=16)  # noqa: E731
        sharded = lambda: sharded_pg.optimize_sharded(g, nccl_world_of_one, n_iters=4,  # noqa: E731
                                                      cg_iters=16)
    else:
        p, _ = synthetic.arc_problem(8, 512, noise_px=0.3, pose_noise=0.02, point_noise=0.03,
                                     device=cuda)
        if solver == "large":
            unsharded = lambda: ba_large.optimize(p, n_iters=4, cg_iters=8)  # noqa: E731
            sharded = lambda: sharded_ba.optimize_large_sharded(  # noqa: E731
                p, nccl_world_of_one, n_iters=4, cg_iters=8)
        else:
            unsharded = lambda: ba.optimize(p, n_iters=4, solver=solver)  # noqa: E731
            sharded = lambda: sharded_ba.optimize_sharded(  # noqa: E731
                p, nccl_world_of_one, n_iters=4, solver=solver)
    counts = []
    outs = []
    for fn in (unsharded, sharded):
        seg_kernel.reduce_launches = seg_kernel.expand_launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts.append((seg_kernel.reduce_launches, seg_kernel.expand_launches))
        outs.append([out[0], out[1], out[-1]] if solver == "pose_graph"
                    else [out[0].R, out[0].t, out[0].X, out[1]])
    assert counts[0] == counts[1] and counts[0][0] > 0
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["entry", "matched"])
def test_entry_step_card_matches_cpu(cuda, case):
    """entry()'s tracking step on the card against the same step on the CPU,
    the same minimal sets injected (drawn on the CPU over the CPU step's
    matches): n_in equal, B1 and B3 once a step. "matched" tracks entry()'s
    frame against a snapshot of its own features (entry.matched_snapshot),
    where the prior-seeded GN decides the pose: R and t within POSE_ATOL.
    entry()'s own snapshot matches nothing and leaves the pose to the DLT of
    one 6-point set, whose float32 null vector two eigensolvers may part on
    by up to entry.dlt_null_vector_bound each: R within twice that bound, t
    within twice that times |t|."""
    from visual_slam_tpu_torch import entry
    from visual_slam_tpu_torch.ops import match, ransac

    step, gargs = entry.entry()
    _, cargs = entry.entry("cpu")
    f = frontend.extract(cargs[0], entry.STEP_FEATURES)
    if case == "matched":
        snap = entry.matched_snapshot(f, cargs[6])
        cargs = (cargs[0], *snap, *cargs[4:])
        gargs = (gargs[0], *(a.to(cuda) for a in snap), *gargs[4:])
    idx2, _, good = match.match_ratio_test(cargs[1], f.desc, cargs[3], f.valid)
    idx = ransac.sample_minimal_sets(torch.Generator().manual_seed(0), entry.STEP_HYPS, 6, good)
    want = step(*cargs, idx=idx)
    n0 = (detect_kernel.launches, patch_kernel.launches)
    got = step(*gargs, idx=idx.to(cuda))
    torch.cuda.synchronize()
    assert (detect_kernel.launches, patch_kernel.launches) == (n0[0] + 1, n0[1] + 1)
    assert int(got[2]) == int(want[2])
    bar_R = bar_t = POSE_ATOL
    if case == "entry":
        assert int(want[2]) == 0
        intr = cargs[6].double()
        xn = ((f.uv[idx2][idx[0]].double() - intr[2:]) / intr[:2]).numpy()
        kappa = entry.dlt_null_vector_bound(cargs[2][idx[0]].numpy(), xn)
        bar_R, bar_t = 2 * kappa, 2 * kappa * float(want[1].norm())
    else:
        assert int(want[2]) > 400
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=bar_R)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=bar_t)
