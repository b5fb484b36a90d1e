#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (visual_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device    require CUDA; print the card's name and power limit
  2. build     compile the hand-written kernels (csrc/*.cu) with nvcc
  3. B1        detect+blur kernel (and its blur-off B2 mode) vs its plain
               PyTorch version on the card, on smoothed noise and a
               checkerboard (plateau ties)
  4. B3        patch kernel vs its plain version, bit-exact, K=1024
  5. frontend  the whole front-end on the card vs the port's CPU path
  6. slice     run_sequence over 60 synthetic RGB-D frames at 640x480,
               K=1024, M=2048: ATE, failures, kernel launch counts, times
  7. ransac    one frame tracked from a prior ~0.3 m / 10 deg off
  8. timing    each kernel beside its plain version at the path's shapes
  9. profile   device time per tracked frame, by kernel (torch.profiler)
 10. B4/B5     segment reduce/expand kernels vs their plain versions at
               BASELINE.json config-#5 shapes, at ragged shapes with
               out-of-range camera ids, and with planted hot cameras
 11. large map config #5 at full scale (5000 keyframes x 1,048,576
               landmarks x 4 observations) through large_map.run: cost drop,
               pose recovery, B4/B5 launch counts, iterations/s, peak memory
 12. LM trace  device busy share and top kernels of one warm large-map
               optimize (torch.profiler)
 13. online BA ba.optimize, solver "chol" and "cg", on a 16-camera,
               2048-point arc built by make_problem
 14. B4/B5 timing  each beside its plain version at config-#5 shapes

Prints the kernels' JSON line, then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero with no result line when
there is no CUDA card. Imports nothing of JAX.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 60
ATE_LIMIT_M = 0.02  # the 200-frame ATE bar of PARITY.md
PEAK_RTOL = 1e-5
BLUR_ATOL = 1e-6
MIN_DESC_BIT_AGREEMENT = 0.995
PRIOR_OFFSET_M = np.array([0.2, -0.15, 0.15])  # 0.29 m off the true centre
PRIOR_OFFSET_DEG = 10.0
# B4 adds with float atomics: the JAX package's bar between its reduce kernel
# and its XLA version (tests/test_pallas_kernels.py:46-48). B5 copies: exact.
REDUCE_RTOL, REDUCE_ATOL = 1e-5, 1e-4
CONFIG5 = dict(K=5000, P=1 << 20, Q=4, n_iters=5, cg_iters=8, lm_lambda=1e-2)


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=200, warmup=20) -> float:
    """Time per call of fn() in ms, between CUDA events around `iters`
    back-to-back calls: the device's time, or the host's where launching
    the calls takes longer than running them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def device_ms(fn, iters=50, tries=3) -> tuple[float, str]:
    """Device time of one fn() call in ms, and how it was measured.

    "profiler": the summed time of every CUDA kernel and copy it runs, from
    torch.profiler, over `iters` calls. A profiler window that recorded no
    device activity is taken again; after `tries` empty windows, "queued"
    (queued_ms)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(_device_us(e) for e in prof.key_averages())
        if us > 0:
            return us / 1e3 / iters, "profiler"
    return queued_ms(fn, iters), "queued"


def queued_ms(fn, iters=50) -> float:
    """Device time of one fn() call in ms: CUDA events around `iters` calls
    queued behind a device-side sleep, so they run back to back (includes
    the ~1 us gaps between launches). Needs no profiler, so it cannot miss
    kernels the way a profiler window that drops events does."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))  # ~0.1 s: the host queues every call meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smooth_noise(h, w, seed):
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    return ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)), 3.0).astype(np.float32)


def checkerboard(h=480, w=640, cell=40):
    return (((np.arange(h)[:, None] // cell) + (np.arange(w)[None, :] // cell)) % 2).astype(np.float32)


def edge_keypoints(H, W, K, seed=0):
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(0, W - 1, K), rng.uniform(0, H - 1, K)], -1)
    uv[:8] = [[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1],
              [3.7, H / 2], [W - 2.2, H / 3], [W / 2, 1.5], [W / 3, H - 4.9]]
    return uv.astype(np.float32)


def desc_bits(desc: torch.Tensor) -> np.ndarray:
    """(K,8) int32 packed descriptors -> (K,256) bits."""
    d = np.ascontiguousarray(desc.cpu().numpy())
    return np.unpackbits(d.view(np.uint8), axis=1)


def perturbed_pose(R_cw, centre, offset_m, angle_deg):
    """A world->camera pose whose centre is `offset_m` off and whose
    rotation is turned by `angle_deg` about a fixed oblique axis."""
    axis = np.array([0.3, 1.0, 0.2]) / np.linalg.norm([0.3, 1.0, 0.2])
    a = np.radians(angle_deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = (np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K) @ R_cw
    return R.astype(np.float32), (-R @ (centre + offset_m)).astype(np.float32)


def rotation_angle_deg(Ra, Rb) -> float:
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


class FrameList:
    """Pre-rendered frames behind the reader interface, so rendering is not
    timed as part of the SLAM run."""

    def __init__(self, frames):
        self._frames = frames

    def frames(self, start=0, stop=None):
        yield from self._frames[start:stop]


def seg_inputs(C, N, K, rng, case="uniform"):
    """(data (C,N), cam (N,), x (C,K)) as NumPy. "ragged": some ids >= K and
    < 0. "hot": 90% of the slots on 3 cameras, with dyadic data (multiples of
    1/256) whose partial sums are exact in f32, so any order gives the same
    bits."""
    cam = rng.integers(0, K, N).astype(np.int32)
    data = rng.normal(size=(C, N)).astype(np.float32)
    if case == "ragged":
        cam[::7], cam[::11] = K + 3, -1
    elif case == "hot":
        hot = rng.uniform(size=N) < 0.9
        cam[hot] = np.array([7, 1234, K - 1], np.int32)[rng.integers(0, 3, int(hot.sum()))]
        data = (rng.integers(-1024, 1024, (C, N)) / 256).astype(np.float32)
    return data, cam, rng.normal(size=(C, K)).astype(np.float32)


def seg_phases(dev, smi) -> dict:
    """Phases 10-14: kernels B4/B5 and the bundle-adjustment back-end."""
    from visual_slam_tpu_torch import large_map
    from visual_slam_tpu_torch.models import ba, ba_large
    from visual_slam_tpu_torch.ops.kernels import seg_kernel
    from visual_slam_tpu_torch.utils.synthetic import arc_problem, build_loop_map

    # 10. B4/B5 vs plain on the card
    K5, N5 = CONFIG5["K"], CONFIG5["P"] * CONFIG5["Q"]
    rng = np.random.default_rng(10)
    err = {"cam_reduce": 0.0, "cam_expand": 0.0}
    for C, N, K, case in [(27, N5, K5, "uniform"), (6, N5, K5, "uniform"), (12, N5, K5, "uniform"),
                          (27, 4097, 257, "ragged"),
                          (5, 100003, 257, "ragged"), (27, N5, K5, "hot")]:
        data, cam, x = seg_inputs(C, N, K, rng, case)
        d, c, xt = (torch.from_numpy(a).to(dev) for a in (data, cam, x))
        rk, rp = seg_kernel.cam_reduce(d, c, K), seg_kernel.cam_reduce_torch(d, c, K)
        ek, ep = seg_kernel.cam_expand(xt, c), seg_kernel.cam_expand_torch(xt, c)
        torch.cuda.synchronize()
        torch.testing.assert_close(rk, rp, rtol=REDUCE_RTOL, atol=REDUCE_ATOL)
        if case == "hot" and not torch.equal(rk, rp):
            raise AssertionError("B4 hot cameras: exact (dyadic) sums differ from the plain version")
        if not torch.equal(ek, ep):
            raise AssertionError(f"B5 ({C},{K})->({C},{N}) {case}: not bit-equal to the plain version")
        rerr = (rk - rp).abs().max().item()
        if case != "ragged":
            err["cam_reduce"] = max(err["cam_reduce"], rerr)
        log(f"[B4/B5] {case} C={C} N={N} K={K}: reduce max_abs_err {rerr:.3g} "
            f"(max |sum| {rp.abs().max().item():.4g}, bit-equal {torch.equal(rk, rp)}); "
            f"expand bit-equal")
        del d, c, xt, rk, rp, ek, ep

    # 11. config #5 at full scale through the large-map entry point
    t0 = time.perf_counter()
    prob, gt = build_loop_map(CONFIG5["K"], CONFIG5["P"], CONFIG5["Q"], seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n, g = CONFIG5["n_iters"], CONFIG5["cg_iters"]
    torch.cuda.reset_peak_memory_stats(dev)
    seg_kernel.reduce_launches = 0
    seg_kernel.expand_launches = 0
    res, _ = large_map.run(prob, gt, n, g, CONFIG5["lm_lambda"])
    launches = {"cam_reduce": seg_kernel.reduce_launches, "cam_expand": seg_kernel.expand_launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    large_map.check(res)
    # Per optimize: B4 n(g+2), B5 1 + n(g+3); the run makes two optimize
    # calls and evaluates the starting cost once more (one B5 launch).
    per_opt = {"cam_reduce": n * (g + 2), "cam_expand": 1 + n * (g + 3)}
    want = {"cam_reduce": 2 * per_opt["cam_reduce"], "cam_expand": 2 * per_opt["cam_expand"] + 1}
    if res["launches_per_optimize"] != per_opt or launches != want:
        raise AssertionError(f"large map: launches {launches} (per optimize "
                             f"{res['launches_per_optimize']}), expected {want} ({per_opt})")
    log(f"[large map] K={res['keyframes']} P={res['landmarks']} N={res['observations']}: "
        f"map built in {build_s:.2f} s; cost {res['cost_before']:.1f} -> {res['cost_after']:.1f} "
        f"(bar < {large_map.COST_DROP} x start), max |t err| {res['max_t_err_m_before']:.5f} -> "
        f"{res['max_t_err_m']:.5f} m")
    log(f"[large map] {res['iters_per_s']:.3f} LM iters/s warm ({res['wall_s_warm']:.4f} s for "
        f"{n} iters x {g} CG), first run {res['wall_s_first']:.4f} s, peak memory {peak_gb:.3f} GB; "
        f"launches {launches} = 2 x {per_opt} + 1 expand (starting cost); {smi}")
    log(f"[large map] first vs warm run of the same optimize: cost {res['cost_after_first']!r} vs "
        f"{res['cost_after']!r}, difference {res['cost_after'] - res['cost_after_first']:.6g} "
        f"(B4's float atomics add in a run-dependent order)")

    # 12. where one warm LM solve's time goes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, cost = ba_large.optimize(prob, n_iters=n, cg_iters=g, init_lambda=CONFIG5["lm_lambda"])
        float(cost)
        wall = time.perf_counter() - t0
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages() if _device_us(e) > 0]
    dev_ms = sum(r[1] for r in rows) / 1e3
    log(f"[LM trace] one warm optimize ({n} LM iters): {dev_ms:.3f} ms device time, "
        f"{sum(r[2] for r in rows)} device ops, {1e3 * wall:.3f} ms wall (profiled): "
        f"device busy share {dev_ms / (1e3 * wall):.3f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"[LM trace]   {us / 1e3:9.4f} ms {count:5d}x  {key[:90]}")
    del prob, gt, prof

    # 13. the online solver on a 16-camera arc
    for solver in ("chol", "cg"):
        p16, _ = arc_problem(16, 2048, 0.5, 0.02, 0.03, seed=1, device=dev)
        cost0 = float(ba._cost(p16))
        seg_kernel.reduce_launches = 0
        seg_kernel.expand_launches = 0
        t0 = time.perf_counter()
        out, cost = ba.optimize(p16, n_iters=10, cg_iters=12, solver=solver)
        cost1 = float(cost)
        wall = time.perf_counter() - t0
        counts = (seg_kernel.reduce_launches, seg_kernel.expand_launches)
        log(f"[online BA] {solver}: K=16 P=2048 N={p16.cam.shape[0]}: cost {cost0:.2f} -> {cost1:.2f} "
            f"in {1e3 * wall:.2f} ms, launches B4 {counts[0]} B5 {counts[1]}")
        if not (np.isfinite(cost1) and cost1 < 0.05 * cost0):
            raise AssertionError(f"online BA {solver}: cost {cost0} -> {cost1}")
        if counts != (10, 1 + 2 * 10):
            raise AssertionError(f"online BA {solver}: launches {counts}, expected (10, 21)")

    # 14. B4/B5 beside their plain versions at config-#5 shapes, in turns.
    #     Queued CUDA events give the times: on an H100, a profiler window
    #     was seen to keep ~1 of 20 B4 launches and read 0.0071 ms (14 TB/s).
    #     The profiler's sum is printed beside them.
    times = {}
    for name, C in [("B4", 27), ("B4", 6), ("B5", 12), ("B5", 6)]:
        data, cam, x = seg_inputs(C, N5, K5, rng)
        d, c, xt = (torch.from_numpy(a).to(dev) for a in (data, cam, x))
        if name == "B4":
            kernel_fn, plain_fn = (lambda: seg_kernel.cam_reduce(d, c, K5),
                                   lambda: seg_kernel.cam_reduce_torch(d, c, K5))
        else:
            kernel_fn, plain_fn = (lambda: seg_kernel.cam_expand(xt, c),
                                   lambda: seg_kernel.cam_expand_torch(xt, c))
        p1, k1, k2, p2 = (queued_ms(f, iters=20) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        kms, pms = min(k1, k2), min(p1, p2)
        kprof, pprof = device_ms(kernel_fn, iters=20)[0], device_ms(plain_fn, iters=20)[0]
        mb = 4 * C * N5 / 1e6
        log(f"[timing] {name} C={C} N={N5} K={K5}: kernel {kms:.4f} ms, plain {pms:.4f} ms device "
            f"(queued events; profiler sums {kprof:.4f} / {pprof:.4f} ms); {mb:.0f} MB of rows: "
            f"kernel at {mb / kms / 1e3:.3f} TB/s; {smi}")
        times.setdefault(name, (kms, pms))
        del d, c, xt
    return {"launches": launches, "err": err, "times": times}


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")

    from visual_slam_tpu_torch.config import SlamConfig
    from visual_slam_tpu_torch.models import frontend
    from visual_slam_tpu_torch.ops.kernels import build, detect_kernel, patch_kernel
    from visual_slam_tpu_torch.pipeline import Slam, run_sequence, track_step
    from visual_slam_tpu_torch.utils.evaluate import ate_rmse
    from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    log(f"[build] {lib_path.name} ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})")

    # 3. B1 (and B2 mode) vs plain, on the card
    b1_err = 0.0
    for name, img_np in [("noise", smooth_noise(480, 640, 0)), ("checker", checkerboard())]:
        img = torch.from_numpy(img_np).to(dev)
        pk, bk = detect_kernel.corner_peaks_and_blur(img)
        pp, bp = detect_kernel.corner_peaks_and_blur_torch(img)
        p2 = detect_kernel.corner_peaks(img)
        torch.cuda.synchronize()
        fin = torch.isfinite(pp)
        if not torch.equal(torch.isfinite(pk), fin) or not torch.equal(torch.isfinite(p2), fin):
            raise AssertionError(f"B1 {name}: finite-peak masks differ")
        torch.testing.assert_close(pk[fin], pp[fin], rtol=PEAK_RTOL, atol=0)
        torch.testing.assert_close(p2[fin], pp[fin], rtol=PEAK_RTOL, atol=0)
        torch.testing.assert_close(bk, bp, rtol=0, atol=BLUR_ATOL)
        perr = (pk[fin] - pp[fin]).abs().max().item()
        berr = (bk - bp).abs().max().item()
        b1_err = max(b1_err, perr, berr)
        log(f"[B1] {name}: {int(fin.sum())} finite peaks, peak max_abs_err {perr:.3g} "
            f"(bit-equal {torch.equal(pk[fin], pp[fin])}), blur max_abs_err {berr:.3g} "
            f"(bit-equal {torch.equal(bk, bp)}); B2 mode bit-equal {torch.equal(p2, pk)}")

    # 4. B3 vs plain, bit-exact
    img = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (480, 640)).astype(np.float32)).to(dev)
    uv = torch.from_numpy(edge_keypoints(480, 640, 1024)).to(dev)
    pk = patch_kernel.extract_patches(img, uv)
    pp = patch_kernel.extract_patches_torch(img, uv)
    torch.cuda.synchronize()
    if not torch.equal(pk, pp):
        raise AssertionError("B3: patches differ from the plain version")
    b3_err = (pk - pp).abs().max().item()
    log(f"[B3] K=1024 (8 edge-clamped) bit-equal: max_abs_err {b3_err}")

    # 5. front-end on the card vs the port's CPU path, same frame
    scene = SyntheticRGBDScene(FRAMES)
    rendered = list(scene.frames())
    gray0 = torch.from_numpy(rendered[FRAMES // 2][1])
    fg = frontend.extract(gray0.to(dev), 1024)
    fc = frontend.extract(gray0, 1024)
    if not torch.equal(fg.uv.cpu(), fc.uv) or not torch.equal(fg.valid.cpu(), fc.valid):
        raise AssertionError("front-end: uv/valid differ between card and CPU")
    torch.testing.assert_close(fg.score.cpu(), fc.score, rtol=PEAK_RTOL, atol=0)
    v = fc.valid.numpy()
    agree = float((desc_bits(fg.desc)[v] == desc_bits(fc.desc)[v]).mean())
    if agree < MIN_DESC_BIT_AGREEMENT:
        raise AssertionError(f"front-end: descriptor bit agreement {agree}")
    log(f"[frontend] uv/valid equal, score within rtol {PEAK_RTOL}, "
        f"{int(v.sum())} valid, descriptor bits equal {agree:.6f}")

    # 6. the slice: run_sequence at full width on the card
    cfg = SlamConfig(use_depth=True)
    run_sequence(FrameList(rendered[:3]), SlamConfig(use_depth=True), device=dev)  # warm-up
    torch.cuda.synchronize()
    detect_kernel.launches = 0
    patch_kernel.launches = 0
    t0 = time.perf_counter()
    slam = run_sequence(FrameList(rendered), cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"detect_blur": detect_kernel.launches, "patch": patch_kernel.launches}
    idxs, est = slam.positions()
    if len(idxs) != FRAMES or not np.isfinite(est).all():
        raise AssertionError(f"slice: {len(idxs)} poses, finite {np.isfinite(est).all()}")
    gt = scene.ground_truth()[idxs, :3, 3]
    ate, _ = ate_rmse(est, gt, align_scale=False)
    summ = slam.timers.summary()
    log(f"[slice] {FRAMES} frames 640x480 K={cfg.frontend.max_features} "
        f"M={cfg.map.track_capacity}: ATE {ate:.6f} m (limit {ATE_LIMIT_M}), stats {slam.stats}")
    log(f"[slice] extract median {summ['extract']['median_ms']:.3f} ms/frame, "
        f"track median {summ['track']['median_ms']:.3f} ms/frame, "
        f"{FRAMES / wall:.2f} frames/s ({wall:.3f} s wall), launches {launches}")
    if ate >= ATE_LIMIT_M:
        raise AssertionError(f"slice: ATE {ate} m >= {ATE_LIMIT_M}")
    if slam.stats["track_failures"] != 0:
        raise AssertionError(f"slice: {slam.stats['track_failures']} track failures")
    for name, count in launches.items():
        if count != FRAMES:
            raise AssertionError(f"slice: kernel {name} launched {count} times for {FRAMES} frames")

    # 7. the RANSAC branch: a prior ~0.3 m and 10 deg off the truth
    i = FRAMES // 2
    feats = frontend.extract(torch.from_numpy(rendered[i][1]).to(dev), 1024)
    R_true, t_true = scene.pose_cw(i)
    c_true = -R_true.T @ t_true
    R_bad, t_bad = perturbed_pose(R_true, c_true, PRIOR_OFFSET_M, PRIOR_OFFSET_DEG)
    step = track_step(
        feats, slam._snapshot, torch.from_numpy(R_bad).to(dev), torch.from_numpy(t_bad).to(dev),
        slam.intr, ratio=cfg.frontend.match_ratio, max_hamming=cfg.frontend.max_hamming,
        threshold_px=cfg.tracking.pnp_threshold_px, n_hyps=cfg.tracking.pnp_hypotheses,
        refine_iters=cfg.tracking.refine_iters, cross_check=cfg.frontend.cross_check,
        generator=slam.generator,
    )
    R_est, t_est = step.R.cpu().numpy(), step.t.cpu().numpy()
    pos_err = float(np.linalg.norm(-R_est.T @ t_est - c_true))
    rot_err = rotation_angle_deg(R_est, R_true)
    log(f"[ransac] prior off by {np.linalg.norm(PRIOR_OFFSET_M):.3f} m / {PRIOR_OFFSET_DEG} deg: "
        f"used_ransac {step.used_ransac}, {int(step.n_inliers)} inliers, "
        f"position error {pos_err:.5f} m, rotation error {rot_err:.4f} deg")
    if not step.used_ransac or pos_err > 0.02 or rot_err > 1.0:
        raise AssertionError("ransac: the branch did not fire or did not recover the pose")

    # 8. kernel times beside the plain versions, at the path's shapes, in
    #    turns (plain, kernel, kernel, plain); the best of each pair
    gray = torch.from_numpy(rendered[i][1]).to(dev)
    _, blurred = detect_kernel.corner_peaks_and_blur(gray)
    uv_path = feats.uv.contiguous()
    fns = {
        "B1": (lambda: detect_kernel.corner_peaks_and_blur(gray),
               lambda: detect_kernel.corner_peaks_and_blur_torch(gray)),
        "B2": (lambda: detect_kernel.corner_peaks(gray),
               lambda: detect_kernel.corner_peaks_torch(gray)),
        "B3": (lambda: patch_kernel.extract_patches(blurred, uv_path),
               lambda: patch_kernel.extract_patches_torch(blurred, uv_path)),
    }
    times = {}
    for name, (kernel_fn, plain_fn) in fns.items():
        p1, k1, k2, p2 = cuda_ms(plain_fn), cuda_ms(kernel_fn), cuda_ms(kernel_fn), cuda_ms(plain_fn)
        kc, pc = min(k1, k2), min(p1, p2)
        p1, k1, k2, p2 = (device_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        times[name] = (min(k1, k2)[0], min(p1, p2)[0])
        methods = sorted({m for _, m in (p1, k1, k2, p2)})
        log(f"[timing] {name}: kernel {times[name][0]:.4f} ms device / {kc:.4f} ms per call; "
            f"plain {times[name][1]:.4f} ms device / {pc:.4f} ms per call "
            f"(device time by {'+'.join(methods)}; {smi})")

    # 9. where a tracked frame's time goes: device kernels by name
    pslam = Slam(cfg, device=dev)
    pslam.process(*rendered[0])
    n_prof = 10
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for frame in rendered[1:1 + n_prof]:
            pslam.process(*frame)
        torch.cuda.synchronize()
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages() if _device_us(e) > 0]
    dev_ms = sum(r[1] for r in rows) / 1e3 / n_prof
    wall_ms = 1e3 * wall / FRAMES
    log(f"[profile] {n_prof} tracked frames: {dev_ms:.3f} ms/frame of device time, "
        f"{sum(r[2] for r in rows) / n_prof:.0f} device ops/frame; against {wall_ms:.3f} ms/frame "
        f"wall in phase 6: device busy share {dev_ms / wall_ms:.3f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"[profile]   {us / 1e3 / n_prof:8.4f} ms/frame {count / n_prof:6.1f}/frame  {key[:90]}")

    seg = seg_phases(dev, smi)

    kernels = [
        dict(name="detect_blur", route="cuda", source="visual_slam_tpu_torch/csrc/detect_blur.cu",
             replaces="visual_slam_tpu/ops/pallas/detect_kernel.py:123",
             launches=launches["detect_blur"], max_abs_err=b1_err,
             ms=times["B1"][0], plain_ms=times["B1"][1]),
        dict(name="patch", route="cuda", source="visual_slam_tpu_torch/csrc/patch.cu",
             replaces="visual_slam_tpu/ops/pallas/patch_kernel.py:32",
             launches=launches["patch"], max_abs_err=b3_err,
             ms=times["B3"][0], plain_ms=times["B3"][1]),
        dict(name="cam_reduce", route="cuda", source="visual_slam_tpu_torch/csrc/seg.cu",
             replaces="visual_slam_tpu/ops/pallas/seg_kernel.py:55",
             launches=seg["launches"]["cam_reduce"], max_abs_err=seg["err"]["cam_reduce"],
             ms=seg["times"]["B4"][0], plain_ms=seg["times"]["B4"][1]),
        dict(name="cam_expand", route="cuda", source="visual_slam_tpu_torch/csrc/seg.cu",
             replaces="visual_slam_tpu/ops/pallas/seg_kernel.py:83",
             launches=seg["launches"]["cam_expand"], max_abs_err=seg["err"]["cam_expand"],
             ms=seg["times"]["B5"][0], plain_ms=seg["times"]["B5"][1]),
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
