#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (visual_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device    require CUDA; print the card's name and power limit, and
               whether the native PNG loader (host IO) builds here
  2. build     compile the hand-written kernels (csrc/*.cu) with nvcc
  3. B1        detect+blur kernel (and its blur-off B2 mode) vs its plain
               PyTorch version on the card, bit for bit, on smoothed noise
               and a checkerboard (plateau ties) at 480x640 and on uniform
               noise at ragged sizes, each with border 16 and 0; on stacks
               (B=4 at 480x640, B=3 at 37x600 and 45x70), one launch bit-
               equal to the plain version and to B single launches
  4. B3        patch kernel vs its plain version, bit-exact, K=1024; on the
               same stacks, one launch bit-equal to both
  5. frontend  the whole front-end on the card vs the port's CPU path;
               extract_batch on 4 frames bit-equal to 4 extract calls
  6. RGB-D     the SLAM loop, run_sequence over 60 synthetic RGB-D frames
               at 640x480, K=1024, M=2048: keyframes with depth mining and
               BA (use_depth, CG-12 x 10 LM) on B4/B5; ATE, failures,
               keyframes, applied BAs, every kernel's launch count, times;
               B4/B5 vs their plain versions at that BA's shapes, B4 ten
               times on normal rows (the same bits each call, no farther
               from float64 sums than index_add_), B4's plan, B5 beside the
               launch floor
  7. ransac    one frame tracked from a prior ~0.3 m / 10 deg off
  8. timing    each kernel beside its plain version at the path's shapes,
               and its bound; B1/B2 also by queued events, beside a copy
               floor for B1's bytes; B3 beside one PyTorch gather; B1 and
               B3 on stacks of B=1, 4 and 8 frames beside B single launches
  9. profile   device time per tracked frame, by kernel (torch.profiler)
 10. B4/B5     segment reduce/expand kernels vs their plain versions at
               BASELINE.json config-#5 shapes, at ragged shapes with
               out-of-range camera ids, and with planted hot cameras; B4 ten
               times at each, the same bits each call, within the float32
               bound of float64 sums
 11. large map config #5 at full scale (5000 keyframes x 1,048,576
               landmarks x 4 observations) through large_map.run: cost drop,
               pose recovery, first and warm run bit-equal, B4/B5 launch
               counts, iterations/s, peak memory, B4's plan
 12. LM trace  device busy share and top kernels of one warm large-map
               optimize (torch.profiler)
 13. online BA ba.optimize, solver "chol" and "cg", on a 16-camera,
               2048-point arc built by make_problem
 14. B4/B5 timing  each beside its plain version, one PyTorch call for
               the same function, and its bound at config-#5 shapes; B5
               also over config #5's own camera ids, B4 also with more
               cameras than slots
 15. monocular the SLAM loop on every 2nd frame, 90 frames at 640x480:
               two-view init (512 essential hypotheses), triangulated
               mining, BA; init frame, keyframes, applied BAs, failures,
               Sim3 ATE, every kernel's launch count, times; then once more
               with homography-vs-essential model selection
 16. init/mine init_step and mine_step on the card vs the port's CPU path
               on the same features and the same minimal sets; init_step
               with model selection on a planar and a general scene
 17. pose graph  optimize and optimize_sim3 on the card vs the port's CPU
               path, SE3 and Sim3, on the 5,000-keyframe graph of the JAX
               package's tests (the CPU and card tests cover the small
               graphs): R, t,
               log-scales within the stated bars, two card calls bit-equal,
               B4/B5 launches a call (and no indexing kernel), ms a call,
               device busy share
 18. loop scoring  score_keyframes at 64 keyframes x 1024 features, card vs
               CPU: equal; ms a call
 19. close loop  Slam._close_loop on RingScene on the card and the CPU: a
               genuine closure under 1.15x scale drift accepted (endpoint
               error halved), a topologically false one rejected with the
               map bit for bit unchanged; the same decisions and stats
 20. RGB-D revisit  run_sequence over 480 frames of the revisiting scene at
               640x480, K=1024, M=2048, default loop settings: closures by
               outcome, ATE, failures, keyframes, BAs, launches, the kf_loop
               timer, frames/s; at least one closure accepted, 0 failures,
               ATE < 0.02 m; a second card run bit-equal
 21. batched   config #3: multi.run_batched over 4 distinct 60-frame RGB-D
               windows of phase 20's frames at 640x480, K=1024, M=2048:
               each sequence's history and poses equal its own
               run_sequence's, the sequences differ, each ATE < 0.02 m with
               0 failures, B1 and B3 launched once a step; frames/s beside
               the four single runs'
 22. sharded   the sharded solvers: (a) over an NCCL world of one rank in
               this process, sharded_ba.optimize_sharded (chol, cg) on the
               16-camera arc, optimize_large_sharded on config #5 at full
               scale and sharded_pg.optimize_sharded on the 5k graph, each
               bit-equal to its unsharded solve with the same B4/B5
               launches; (b) 4 gloo ranks on the one card through
               multihost.spawn_worker_fleet, config #5 and the 5k graph,
               held to the unsharded card solve at the JAX tests' bars
               (config #5's landmarks at the solve's own float32 spread),
               two fleet runs bit-equal; each rank's warm iterations/s,
               peak memory, B4/B5 launches, all-reduced bytes, and the
               share of a profiled solve spent inside all-reduces;
               B4/B5 at rank 0's pose-graph shapes beside index_add_ /
               index_select and their bounds
 23. cli       phase 6's 60 frames written to disk in the ICL-NUIM layout;
               `python -m visual_slam_tpu_torch.pipeline --rgbd
               --pose-graph` with PLY, g2o and checkpoint (and, where
               matplotlib imports, the trajectory plot and live dump) as a
               subprocess that prints its kernel launches after the run,
               equal to run_sequence in this process (keyframes, init
               frame, bit-equal centres, launches); the artifacts load back
 24. pipelined run_pipelined (depth 8) over phase 6's, 15's and 20's frames,
               each beside its serial run: RGB-D twice (bit-equal) and on
               the CPU (the same history, centres within 1e-3); monocular
               against a CPU run (the same frames until the second BA
               applies, centres within 1e-4; init frame, re-anchors,
               re-verification rejects and backfills printed; phase 15's
               bars); the revisit once (its ATE and closures printed: the
               pipelined driver loses that scene's fast turn, as the JAX
               package's does); 0 failures, ATE < 0.02 m for RGB-D and
               monocular; frames/s, host syncs per tracked frame and per
               init attempt, device busy share over a profiled window, and
               launches, beside the serial run's
 25. entry     the entry module (entry.py): entry()'s tracking step on the
               card against the CPU with the same minimal sets, on its own
               snapshot (RANSAC's DLT decides the pose) and on one of the
               frame's own features (the GN branch, R and t 1e-4), n_in
               equal, B1 and B3 once a step, median ms over 20 steps each;
               the stage table of one tracked frame (roofline.stage_table
               on queued-event times, 640x480, K=1024, M=2048);
               dryrun_multichip(1) on an NCCL world of one rank against
               the same call on the CPU, its seconds
 26. bench     `python -m visual_slam_tpu_torch.bench --frames 80
               --fullseq-frames 0 --sections headline,device_rate,roofline`
               as a subprocess: exit 0, its full record and compact headline
               as the last two lines, naming this card, "correct" true, B1
               and B3 once a frame of each headline run; its headline logged

Prints the kernels' JSON line, then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero with no result line when
there is no CUDA card. Imports nothing of JAX.
"""
import concurrent.futures
import json
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from visual_slam_tpu_torch.ops.kernels import launch_counts as kernel_counts
from visual_slam_tpu_torch.utils.cuda_timing import cuda_ms, device_ms, device_us, queued_ms

FRAMES = 60
ATE_LIMIT_M = 0.02  # the 200-frame ATE bar of PARITY.md
MONO_STRIDE, MONO_FRAMES = 2, 90  # every 2nd frame, 90 processed
# The JAX package's Slam on the same monocular sequence (CPU): init at frame
# 18, keyframes at 0/18/60/102/144, 7 BAs, Sim3 ATE 0.00345 m.
MONO_INIT_FRAME = 18
MIN_MONO_KEYFRAMES, MIN_MONO_BA = 3, 5
# init_step / mine_step on the card vs on the CPU, float32 eigh and SVD in
# cuSOLVER vs LAPACK: R, t (the CPU parity bar of tests/test_torch_twoview.py),
# median parallax (degrees), and triangulated points as pixels: reprojected
# into either camera, the card's and the CPU's point land this close. A
# point's disagreement along its ray grows as 1/parallax (up to 7.7e-4 of its
# range on the init pair, on an H100) but moves its image by parallax x that.
GEOM_POSE_ATOL, GEOM_PARALLAX_ATOL, GEOM_REPROJ_PX = 1e-4, 1e-3, 0.02
PEAK_RTOL = 1e-5  # front-end score, card vs CPU
MIN_DESC_BIT_AGREEMENT = 0.995
PRIOR_OFFSET_M = np.array([0.2, -0.15, 0.15])  # 0.29 m off the true centre
PRIOR_OFFSET_DEG = 10.0
# B4 against index_add_, which sums in another order: the JAX package's bar
# between its reduce kernel and its XLA version (tests/test_pallas_kernels.py:
# 46-48), where a camera has few slots; bit-equal on dyadic rows. B5 copies:
# exact.
REDUCE_RTOL, REDUCE_ATOL = 1e-5, 1e-4
CONFIG5 = dict(K=5000, P=1 << 20, Q=4, n_iters=5, cg_iters=8, lm_lambda=1e-2)
# Pose graph, card vs CPU (phase 17): B4 adds in another order than
# index_add_, and 12 GN steps of 32 CG iterations carry the difference.
# Rotations and log-scales 1e-4, translations 1e-3 (metres on the 5k graph's
# ~100 m chain; the chain's own noise is 0.02 m).
PG_R_ATOL, PG_T_ATOL, PG_LAM_ATOL = 1e-4, 1e-3, 1e-4
REVISIT_FRAMES = 480  # the turn at ~0.83 deg a frame: the prior-seeded PnP's reach at 640x480
# Config #3 (phase 21): windows of phase 20's frames, (offset, reversed).
BATCH_WINDOWS, BATCH_LENGTH = ((0, False), (120, True), (240, False), (360, False)), 60
# Stacks for the batched B1/B3 checks (phases 3 and 4): (B, (H, W)).
BATCH_CASES = ((4, (480, 640)), (3, (37, 600)), (3, (45, 70)))
RENDER_THREADS = 6


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def smooth_noise(h, w, seed):
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    return ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)), 3.0).astype(np.float32)


def uniform_noise(h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (h, w)).astype(np.float32)


# B1's ragged sizes (tests/torch_parity.py): no side a multiple of its 60x20
# tile, images narrower or shorter than a tile, one inside the border frame.
RAGGED_SIZES = [(479, 637), (240, 320), (45, 70), (37, 600), (30, 30)]


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


def count_syncs(fn) -> int:
    """Host-device synchronisations in one fn() call, counted by torch's
    sync-debug mode (one warning per synchronising call)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def runtime_syncs(fn) -> int:
    """Host-blocking CUDA runtime calls (stream, device or event
    synchronise, blocking cudaMemcpy) in one fn() call, read from a
    torch.profiler trace of the runtime API."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return sum(e.count for e in prof.key_averages() if e.key in SYNC_CALLS)


def zero_kernel_counts() -> None:
    from visual_slam_tpu_torch.ops.kernels import detect_kernel, patch_kernel, seg_kernel

    detect_kernel.launches = patch_kernel.launches = 0
    seg_kernel.reduce_launches = seg_kernel.expand_launches = 0


def run_slam(frames, cfg, dev, stamps=None):
    """run_sequence on the card with every kernel count set to 0 just before
    and read just after. Returns (slam, wall seconds, launches). `stamps`,
    a list, gets the host clock after each frame."""
    from visual_slam_tpu_torch.pipeline import run_sequence

    on_frame = None if stamps is None else (lambda slam, i: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    zero_kernel_counts()
    t0 = time.perf_counter()
    slam = run_sequence(FrameList(frames), cfg, device=dev, on_frame=on_frame)
    torch.cuda.synchronize()
    return slam, time.perf_counter() - t0, kernel_counts()


def check_slam_launches(name, slam, n_frames, launches):
    """B1 and B3 once per frame; per BA step B4 once per LM iteration and B5
    2 x iterations + 3 times (cost before, starting cost, per iteration the
    build and the candidate's cost, reprojection errors after); B5 once more
    per monocular init quality gate."""
    st = slam.stats
    n_ba = st["ba_runs"] + st["ba_dropped_stale"] + st["ba_rejected"] + (slam._pending_ba is not None)
    gates = 0 if slam.cfg.use_depth else st["init_rollbacks"] + (st["init_frame"] is not None)
    it = slam.cfg.ba.iters
    want = {"detect_blur": n_frames, "patch": n_frames, "cam_reduce": it * n_ba,
            "cam_expand": (2 * it + 3) * n_ba + gates}
    if launches != want or n_ba == 0:
        raise AssertionError(f"{name}: launches {launches}, expected {want} ({n_ba} BA steps)")
    return n_ba


def slam_report(name, slam, n_frames, wall, launches, n_ba, ate, smi):
    summ = slam.timers.summary()
    med = lambda k: f"{summ[k]['median_ms']:.3f} ms ({summ[k]['calls']} calls)" if k in summ else "none"
    st = slam.stats
    log(f"[{name}] {n_frames} frames: {n_frames / wall:.2f} frames/s ({wall:.3f} s wall), "
        f"ATE {ate:.6f} m (limit {ATE_LIMIT_M}), init frame {st['init_frame']}, "
        f"keyframes at {[f.frame_idx for f in slam.trajectory if f.is_keyframe]}; {smi}")
    log(f"[{name}] median per call: extract {med('extract')}, track {med('track')}, "
        f"init attempt {med('initialize')}, keyframe insertion {med('kf_insert')}, "
        f"BA solve {med('ba_solve')}; BA {slam.ba_iters_per_s():.2f} LM iters/s")
    log(f"[{name}] BA steps {n_ba}: applied {st['ba_runs']}, dropped {st['ba_dropped_stale']}, "
        f"rejected {st['ba_rejected']}; launches {launches}; stats {st}")


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


# The H100 SXM's published peaks (NVIDIA's datasheet): device memory
# and float32 outside the tensor cores, in units per ms.
HBM_BYTES_PER_MS, FP32_FLOPS_PER_MS = 3.35e9, 67e9


def bound_ms(nbytes, flops):
    """The least time the card could take for work that moves `nbytes`
    (each input read once, each output written once) and does `flops`
    float32 operations: (ms, "bytes" or "operations")."""
    b, f = nbytes / HBM_BYTES_PER_MS, flops / FP32_FLOPS_PER_MS
    return (b, "bytes") if b >= f else (f, "operations")


def library_patch(img, uv):
    """One PyTorch call that computes B3's function: an advanced-indexing
    gather of the (K,32,32) patches, with its row and column indices built
    once from the patch corners."""
    from visual_slam_tpu_torch.ops.kernels import patch_kernel

    H, W = img.shape
    c = patch_kernel.patch_corners(uv, H, W).to(torch.int64)
    ar = torch.arange(patch_kernel.PATCH, device=img.device)
    rows, cols = (c[:, 1, None] + ar)[:, :, None], (c[:, 0, None] + ar)[:, None, :]
    return lambda: img[rows, cols]


def library_reduce(data, cam, K):
    """One PyTorch call that computes B4's function: index_add_ into a
    (C,K+1) buffer whose last column takes the out-of-range ids."""
    from visual_slam_tpu_torch.ops.kernels import seg_kernel

    idx = seg_kernel._slot_index(cam, K)
    buf = torch.zeros((data.shape[0], K + 1), device=data.device)
    return lambda: buf.index_add_(1, idx, data)


def library_expand(x, cam):
    """One PyTorch call that computes B5's function: index_select from the
    table with a zero column for the out-of-range ids."""
    from visual_slam_tpu_torch.ops.kernels import seg_kernel

    idx = seg_kernel._slot_index(cam, x.shape[1])
    padded = torch.cat([x, torch.zeros((x.shape[0], 1), device=x.device)], dim=1)
    return lambda: padded.index_select(1, idx)


def exact_reduce(data, cam, K):
    """B4's function in float64 on float32 rows (C,N): ((C,K) sums, (C,K)
    bound). The bound is the most that any order of float32 additions may
    be off: gamma_(n-1) * sum |x| over a camera's n slots, with
    gamma_m = m u / (1 - m u) and u = 2^-24 (Higham, Accuracy and Stability
    of Numerical Algorithms, 2nd ed., eq. 4.6)."""
    from visual_slam_tpu_torch.ops.kernels import seg_kernel

    d = data.double()
    exact = seg_kernel.cam_reduce_torch(d, cam, K)
    abs_sum = seg_kernel.cam_reduce_torch(d.abs(), cam, K)
    m = (seg_kernel.cam_reduce_torch(torch.ones_like(d[:1]), cam, K) - 1).clamp(min=0) * 2.0 ** -24
    return exact, m / (1 - m) * abs_sum


def check_reduce_repeats(name, data, cam, K, plan, hot=False) -> tuple[float, float]:
    """B4 on `data` ten times: the same bits every call, within the bound of
    any float32 order of the float64 sums and, where thousands of slots
    share a camera (`hot`), no farther from them than index_add_. Returns
    the largest distance of B4 and of index_add_ from the float64 sums."""
    from visual_slam_tpu_torch.ops.kernels import seg_kernel

    first = seg_kernel.cam_reduce(data, cam, K, plan)
    if not all(torch.equal(seg_kernel.cam_reduce(data, cam, K, plan), first) for _ in range(9)):
        raise AssertionError(f"{name}: B4 gave other bits on a repeated call")
    exact, bound = exact_reduce(data, cam, K)
    err = (first.double() - exact).abs()
    kerr = err.max().item()
    lerr = (seg_kernel.cam_reduce_torch(data, cam, K).double() - exact).abs().max().item()
    if not (err <= bound).all():
        raise AssertionError(f"{name}: B4 is {kerr} from the float64 sums, past the float32 bound")
    if hot and kerr > lerr:
        raise AssertionError(f"{name}: B4 is {kerr} from the float64 sums, index_add_ {lerr}")
    return kerr, lerr


def seg_phases(dev, smi) -> dict:
    """Phases 10-14: kernels B4/B5 and the bundle-adjustment back-end."""
    from visual_slam_tpu_torch import large_map
    from visual_slam_tpu_torch.models import ba, ba_large
    from visual_slam_tpu_torch.ops.kernels import seg_kernel
    from visual_slam_tpu_torch.utils.synthetic import arc_problem, build_loop_map

    # 10. B4/B5 vs plain on the card
    K5, N5 = CONFIG5["K"], CONFIG5["P"] * CONFIG5["Q"]
    rng = np.random.default_rng(10)
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
        # Ten calls on normal rows (the hot case's rows above are dyadic).
        dn = d if case != "hot" else torch.from_numpy(rng.normal(size=(C, N)).astype(np.float32)).to(dev)
        kerr, lerr = check_reduce_repeats(f"B4 ({C},{N})->({C},{K}) {case}", dn, c, K,
                                          seg_kernel.reduce_plan(c, K), hot=case == "hot")
        log(f"[B4/B5] {case} C={C} N={N} K={K}: reduce max_abs_err {rerr:.3g} "
            f"(max |sum| {rp.abs().max().item():.4g}, bit-equal {torch.equal(rk, rp)}), the same bits "
            f"on 10 calls on normal rows, there {kerr:.3g} from the float64 sums (index_add_ "
            f"{lerr:.3g}); expand bit-equal")
        del d, c, xt, rk, rp, ek, ep, dn

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
    # B4's reduce plan of config #5, built once per optimize call
    plan5_ms = cuda_ms(lambda: seg_kernel.reduce_plan(prob.cam, CONFIG5["K"]), iters=10, warmup=2)
    plan5 = seg_kernel.reduce_plan(prob.cam, CONFIG5["K"])
    log(f"[large map] first and warm runs end on the same cost, {res['cost_after']!r}; B4's plan "
        f"({plan5.tile}-slot tiles, {int(plan5.tile_ptr[-1])} of at most {plan5.max_runs} runs): "
        f"built in {plan5_ms:.4f} ms, {plan5.nbytes() / 1e6:.3f} MB, plus "
        f"{27 * plan5.max_runs * 4 / 1e6:.3f} MB of partials during the build's 27-row reduce")
    del plan5

    # 12. where one warm LM solve's time goes
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, cost = ba_large.optimize(prob, n_iters=n, cg_iters=g, init_lambda=CONFIG5["lm_lambda"])
        float(cost)
        wall = time.perf_counter() - t0
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages() if device_us(e) > 0]
    dev_ms = sum(r[1] for r in rows) / 1e3
    log(f"[LM trace] one warm optimize ({n} LM iters): {dev_ms:.3f} ms device time, "
        f"{sum(r[2] for r in rows)} device ops, {1e3 * wall:.3f} ms wall (profiled): "
        f"device busy share {dev_ms / (1e3 * wall):.3f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"[LM trace]   {us / 1e3:9.4f} ms {count:5d}x  {key[:90]}")
    path_cam = prob.cam  # the path's camera ids, timed in phase 14
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

    # 14. B4/B5 beside their plain versions at config-#5 shapes, and B4 at
    #     the card test's K > N shape, in turns. Queued CUDA events give the
    #     times: on an H100, a profiler window was seen to keep ~1 of 20 B4
    #     launches and read 0.0071 ms (14 TB/s). The profiler's sum is
    #     printed beside them. B4 runs over a plan built once, as in an
    #     optimize call. B5 also over config #5's own camera ids.
    seg_times = {}
    for name, C, N, K, ids in [("B4", 27, N5, K5, "uniform"), ("B4", 6, N5, K5, "uniform"),
                               ("B5", 12, N5, K5, "uniform"), ("B5", 6, N5, K5, "uniform"),
                               ("B5", 12, N5, K5, "path"), ("B5", 6, N5, K5, "path"),
                               ("B4", 3, 50000, 100000, "uniform")]:
        data, cam, x = seg_inputs(C, N, K, rng)
        d, c, xt = (torch.from_numpy(a).to(dev) for a in (data, cam, x))
        if ids == "path":
            c = path_cam
            if not torch.equal(seg_kernel.cam_expand(xt, c), seg_kernel.cam_expand_torch(xt, c)):
                raise AssertionError(f"B5 ({C},{K})->({C},{N}) on config #5's ids: not bit-equal")
        if name == "B4":
            plan = seg_kernel.reduce_plan(c, K)
            kernel_fn, plain_fn, library_fn = (lambda: seg_kernel.cam_reduce(d, c, K, plan),
                                               lambda: seg_kernel.cam_reduce_torch(d, c, K),
                                               library_reduce(d, c, K))
            bound = bound_ms(4 * (C * N + N + C * K), C * N)
        else:
            kernel_fn, plain_fn, library_fn = (lambda: seg_kernel.cam_expand(xt, c),
                                               lambda: seg_kernel.cam_expand_torch(xt, c),
                                               library_expand(xt, c))
            bound = bound_ms(4 * (C * K + N + C * N), 0)
        p1, k1, k2, p2 = (queued_ms(f, iters=20) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        kms, pms = min(k1, k2), min(p1, p2)
        lms = queued_ms(library_fn, iters=20)
        kprof, pprof = device_ms(kernel_fn, iters=20)[0], device_ms(plain_fn, iters=20)[0]
        mb = 4 * C * N / 1e6
        seg_times[(name, C, N, K, ids)] = (kms, pms, lms, bound)
        log(f"[timing] {name} C={C} N={N} K={K} ({ids} ids): kernel {kms:.4f} ms, plain {pms:.4f} ms, "
            f"library {lms:.4f} ms device (queued events; profiler sums {kprof:.4f} / {pprof:.4f} ms); "
            f"{mb:.0f} MB of rows: kernel at {mb / kms / 1e3:.3f} TB/s; bound {bound[0]:.4f} ms "
            f"({bound[1]}): kernel at {bound[0] / kms:.3f} of its bound"
            + (f"; {plan.tile}-slot tiles, {int(plan.tile_ptr[-1])} runs" if name == "B4" else "")
            + f"; {smi}")
        del d, c, xt
    del path_cam
    return seg_times


def reproj_px(Xa, Xb, poses, intr, mask) -> float:
    """Largest pixel distance between the images of two point sets (CPU
    tensors) in any of the cameras `poses`, over `mask`."""
    from visual_slam_tpu_torch.ops import projection

    return max(float((projection.project(R, t, Xa, intr)[0] - projection.project(R, t, Xb, intr)[0])
                     .norm(dim=-1)[mask].max()) for R, t in poses)


def two_view_features(planar: bool, rng, intr, n_pts=300):
    """Features of two views of n_pts points, on the plane z = 4 (as
    tests/test_homography.py:planar_scene builds it) or with depths spread
    over [2, 8] m, with 0.3 px noise. Each point is one feature, with the
    same random descriptor in both views, so matching pairs them."""
    from visual_slam_tpu_torch.models.frontend import Features
    from visual_slam_tpu_torch.ops import lie

    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                  np.full(n_pts, 4.0) if planar else rng.uniform(2.0, 8.0, n_pts)], -1)
    R = lie.so3_exp(torch.tensor([0.05, -0.08, 0.02])).double().numpy()
    X2 = X @ R.T + np.array([0.4, -0.15, 0.25])
    fx, fy, cx, cy = np.asarray(intr, np.float64)
    desc = torch.from_numpy(rng.integers(-2**31, 2**31, (n_pts, 8)).astype(np.int32))
    feats = []
    for P in (X, X2):
        uv = np.stack([fx * P[:, 0] / P[:, 2] + cx, fy * P[:, 1] / P[:, 2] + cy], -1)
        uv = torch.from_numpy((uv + rng.normal(scale=0.3, size=uv.shape)).astype(np.float32))
        feats.append(Features(uv=uv, desc=desc, score=torch.ones(n_pts), valid=torch.ones(n_pts, dtype=torch.bool)))
    return feats


def mono_phases(dev, smi) -> tuple[dict, tuple]:
    """Phases 15-16: the monocular SLAM loop, once with model selection,
    and init_step / mine_step on the card against the port's CPU path.
    Returns each run's launches, and (frames, ground truth, serial wall
    seconds, host clock after each frame) of phase 15's run for phase 24."""
    from visual_slam_tpu_torch.config import SlamConfig
    from visual_slam_tpu_torch.models import frontend
    from visual_slam_tpu_torch.ops import match, ransac
    from visual_slam_tpu_torch.pipeline import init_step, mine_step
    from visual_slam_tpu_torch.utils.evaluate import ate_rmse
    from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

    # 15. the monocular SLAM loop at full width
    n_total = MONO_STRIDE * (MONO_FRAMES - 1) + 1
    scene = SyntheticRGBDScene(n_total)
    t0 = time.perf_counter()
    frames = [(i, scene.render(i)[0], None) for i in range(0, n_total, MONO_STRIDE)]
    log(f"[mono] rendered {len(frames)} frames in {time.perf_counter() - t0:.1f} s")
    stamps = []
    slam, wall, launches = run_slam(frames, SlamConfig(), dev, stamps)
    idxs, est = slam.positions()
    if not np.isfinite(est).all():
        raise AssertionError("mono: non-finite poses")
    ate, _ = ate_rmse(est, scene.ground_truth()[idxs, :3, 3], align_scale=True)
    n_ba = check_slam_launches("mono", slam, MONO_FRAMES, launches)
    slam_report("mono", slam, MONO_FRAMES, wall, launches, n_ba, ate, smi)
    st = slam.stats
    if st["init_frame"] != MONO_INIT_FRAME:
        raise AssertionError(f"mono: init at frame {st['init_frame']}, the reference's is {MONO_INIT_FRAME}")
    if st["keyframes"] < MIN_MONO_KEYFRAMES or st["ba_runs"] < MIN_MONO_BA:
        raise AssertionError(f"mono: {st['keyframes']} keyframes inserted, {st['ba_runs']} BAs applied")
    if st["track_failures"] != 0 or ate >= ATE_LIMIT_M:
        raise AssertionError(f"mono: {st['track_failures']} track failures, Sim3 ATE {ate} m")
    # The final pose-graph pass: the SE3 chain with its scale edges (no
    # closure in this run), kept unless it grows the blown fraction.
    t0 = time.perf_counter()
    slam.optimize_pose_graph()
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    idxs, est = slam.positions()
    ate_final, _ = ate_rmse(est, scene.ground_truth()[idxs, :3, 3], align_scale=True)
    log(f"[mono] final pose-graph pass: {st['final_pass']} in {pass_s:.3f} s, Sim3 ATE "
        f"{ate:.6f} -> {ate_final:.6f} m; {smi}")
    if st["final_pass"] not in ("smooth", "reverted") or not np.isfinite(ate_final):
        raise AssertionError(f"mono: final pass {st['final_pass']}, ATE {ate_final}")
    # The same frames with homography-vs-essential model selection at init
    # (TwoViewConfig.use_model_selection; the JAX package's CPU Slam and the
    # port's pick the homography at the box room's half-size init pair).
    cfg_ms = SlamConfig()
    cfg_ms.twoview.use_model_selection = True
    slam_ms, wall_ms, launches_ms = run_slam(frames, cfg_ms, dev)
    idxs, est = slam_ms.positions()
    ate_ms, _ = ate_rmse(est, scene.ground_truth()[idxs, :3, 3], align_scale=True)
    n_ba_ms = check_slam_launches("mono model selection", slam_ms, MONO_FRAMES, launches_ms)
    slam_report("mono model selection", slam_ms, MONO_FRAMES, wall_ms, launches_ms, n_ba_ms, ate_ms, smi)
    sm = slam_ms.stats
    log(f"[mono model selection] accepted init at frame {sm['init_frame']} chose the {sm['init_model']} "
        f"({sm['init_rollbacks']} rollbacks, {sm['init_reverify_rejects']} re-verification rejects); "
        f"without selection: frame {st['init_frame']}, the {st['init_model']}")
    if sm["init_frame"] is None or sm["track_failures"] != 0 or not ate_ms < ATE_LIMIT_M:
        raise AssertionError(f"mono model selection: init {sm['init_frame']}, {sm['track_failures']} track "
                             f"failures, Sim3 ATE {ate_ms} m")

    # 16. init_step and mine_step on the card vs the CPU: the same CPU
    #     features, the same minimal sets
    cfg = SlamConfig()
    fc = {i: frontend.extract(torch.from_numpy(scene.render(i)[0]), 1024) for i in (0, MONO_INIT_FRAME, 30)}
    fg = {i: frontend.Features(*(a.to(dev) for a in f)) for i, f in fc.items()}
    intr = torch.as_tensor(cfg.intrinsics)
    fq = cfg.frontend
    _, _, good = match.match_ratio_test(fc[0].desc, fc[MONO_INIT_FRAME].desc, fc[0].valid,
                                        fc[MONO_INIT_FRAME].valid, ratio=fq.match_ratio,
                                        max_distance=fq.max_hamming)
    idx = ransac.sample_minimal_sets(torch.Generator().manual_seed(0), 512, 8, good)
    kw = dict(ratio=fq.match_ratio, max_hamming=fq.max_hamming,
              ess_threshold=cfg.twoview.ess_threshold_factor / float(cfg.intrinsics[0]),
              distance_thresh=cfg.twoview.distance_thresh, n_hyps=512,
              min_flow_px=cfg.twoview.min_flow_px)
    poses = {i: [torch.from_numpy(a.astype(np.float32)) for a in scene.pose_cw(i)] for i in (0, 30)}
    avail = fc[0].valid & (torch.arange(1024) % 3 != 0)
    mkw = dict(ratio=fq.match_ratio, max_hamming=fq.max_hamming, reproj_thresh_px=4.0, max_depth=10.0,
               min_parallax_deg=3.0)
    pose_dev, intr_dev, idx_dev, avail_dev = ([a.to(dev) for a in poses[0] + poses[30]],
                                              intr.to(dev), idx.to(dev), avail.to(dev))
    calls = {  # the card's calls, inputs already on the card
        "init_step": lambda: init_step(fg[0], fg[MONO_INIT_FRAME], intr_dev, **kw, ransac_idx=idx_dev),
        "mine_step": lambda: mine_step(fg[0], avail_dev, fg[30], *pose_dev, intr_dev, **mkw),
    }
    ic = init_step(fc[0], fc[MONO_INIT_FRAME], intr, **kw, ransac_idx=idx)
    ig = calls["init_step"]()
    for name in ("n_matches", "idx2", "cheir", "frac"):
        if not torch.equal(getattr(ig, name).cpu(), getattr(ic, name)):
            raise AssertionError(f"init_step: {name} differs between card and CPU")
    torch.testing.assert_close(ig.R.cpu(), ic.R, rtol=0, atol=GEOM_POSE_ATOL)
    torch.testing.assert_close(ig.t.cpu(), ic.t, rtol=0, atol=GEOM_POSE_ATOL)
    par_err = abs(float(ig.parallax) - float(ic.parallax))
    x_rel = float(((ig.X1.cpu() - ic.X1).norm(dim=-1) / ic.X1.norm(dim=-1))[ic.cheir].max())
    x_px = reproj_px(ig.X1.cpu(), ic.X1, [(torch.eye(3), torch.zeros(3)), (ic.R, ic.t)], intr, ic.cheir)
    if par_err > GEOM_PARALLAX_ATOL or x_px > GEOM_REPROJ_PX or float(ic.frac) < cfg.twoview.min_valid_fraction:
        raise AssertionError(f"init_step: parallax err {par_err}, points {x_px} px apart, frac {float(ic.frac)}")
    mc = mine_step(fc[0], avail, fc[30], *poses[0], *poses[30], intr, **mkw)
    mg = calls["mine_step"]()
    for name in ("idx2", "keep", "keep_loose"):
        if not torch.equal(getattr(mg, name).cpu(), getattr(mc, name)):
            raise AssertionError(f"mine_step: {name} differs between card and CPU")
    loose = mc.keep_loose
    mx_rel = float(((mg.X.cpu() - mc.X).norm(dim=-1) / mc.X.norm(dim=-1))[loose].max())
    mx_px = reproj_px(mg.X.cpu(), mc.X, [poses[0], poses[30]], intr, loose)
    if mx_px > GEOM_REPROJ_PX or not 0 < int(mc.keep.sum()) < int(loose.sum()):
        raise AssertionError(f"mine_step: points {mx_px} px apart, keep {int(mc.keep.sum())} "
                             f"of {int(loose.sum())}")
    cost = {name: (cuda_ms(fn, iters=10, warmup=2), device_ms(fn, iters=3)[0], count_syncs(fn))
            for name, fn in calls.items()}
    log(f"[init/mine] init_step (0, {MONO_INIT_FRAME}): {int(ic.n_matches)} matches, frac "
        f"{float(ic.frac):.4f}, parallax {float(ic.parallax):.4f} deg, card vs CPU: idx2/cheir/frac "
        f"equal, parallax err {par_err:.3g} deg, points apart by at most {x_rel:.3g} of their "
        f"range and {x_px:.3g} px in either image")
    log(f"[init/mine] mine_step (0, 30): keep {int(mc.keep.sum())}, loose {int(loose.sum())}, "
        f"card vs CPU: masks equal, points apart by at most {mx_rel:.3g} of their range and "
        f"{mx_px:.3g} px in either image")
    for name, (ms, dev_ms, syncs) in cost.items():
        log(f"[init/mine] {name}: {ms:.3f} ms per call, {dev_ms:.3f} ms device, {syncs} host "
            f"syncs per call; {smi}")
    # init_step with homography-vs-essential model selection, card vs CPU,
    # the same essential and homography minimal sets: a planar scene (the
    # homography wins) and a general one (the essential matrix wins).
    rng = np.random.default_rng(16)
    kw_ms = {**kw, "min_flow_px": 0.0, "model_selection": True}  # the flow floor is not under test
    for planar in (True, False):
        f0, f1 = two_view_features(planar, rng, cfg.intrinsics)
        _, _, good = match.match_ratio_test(f0.desc, f1.desc, f0.valid, f1.valid, ratio=fq.match_ratio,
                                            max_distance=fq.max_hamming)
        g = torch.Generator().manual_seed(int(planar))
        idx_e, idx_h = (ransac.sample_minimal_sets(g, 512, k, good) for k in (8, 4))
        ic = init_step(f0, f1, intr, **kw_ms, ransac_idx=idx_e, homography_idx=idx_h)
        sel = lambda: init_step(*(frontend.Features(*(a.to(dev) for a in f)) for f in (f0, f1)),  # noqa: E731
                                intr_dev, **kw_ms, ransac_idx=idx_e.to(dev), homography_idx=idx_h.to(dev))
        ig = sel()
        name = "planar" if planar else "general"
        if bool(ig.used_H) != bool(ic.used_H) or bool(ic.used_H) != planar:
            raise AssertionError(f"init_step model selection, {name}: used_H card {bool(ig.used_H)}, "
                                 f"CPU {bool(ic.used_H)}")
        torch.testing.assert_close(ig.R.cpu(), ic.R, rtol=0, atol=GEOM_POSE_ATOL)
        torch.testing.assert_close(ig.t.cpu(), ic.t, rtol=0, atol=GEOM_POSE_ATOL)
        r_err = float((ig.R.cpu() - ic.R).abs().max())
        t_err = float((ig.t.cpu() - ic.t).abs().max())
        log(f"[init/mine] init_step model selection, {name} scene ({int(ic.n_matches)} matches): the "
            f"{'homography' if planar else 'essential matrix'} on card and CPU, frac {float(ic.frac):.4f}, "
            f"R within {r_err:.3g}, t within {t_err:.3g} (bar {GEOM_POSE_ATOL}); "
            f"{cuda_ms(sel, iters=5, warmup=1):.3f} ms per call; {smi}")
    return ({"mono": launches, "mono_model_selection": launches_ms},
            (frames, scene.ground_truth(), wall, stamps))


def sim3_of(g):
    """The Sim3 graph over a PoseGraph's SE3 edges: log-scales 0, Z_s = 1."""
    from visual_slam_tpu_torch.models import pose_graph as pg

    z = torch.zeros_like
    return pg.Sim3Graph(R=g.R, t=g.t, lam=z(g.t[:, 0]), e_i=g.e_i, e_j=g.e_j, Z_R=g.Z_R, Z_t=g.Z_t,
                        Z_ls=z(g.w), w=g.w, w_lam=g.w, fixed=g.fixed)


def to_device(g, dev):
    return type(g)(*(a.to(dev) for a in g))


def render_revisit(n_frames):
    """The revisiting scene's frames, rendered in RENDER_THREADS threads
    (NumPy and SciPy release the GIL for most of a frame)."""
    from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

    scene = SyntheticRGBDScene(n_frames, trajectory="revisit")
    with concurrent.futures.ThreadPoolExecutor(RENDER_THREADS) as ex:
        return list(ex.map(lambda i: (i, *scene.render(i)), range(n_frames)))


INDEXING = re.compile(r"indexFunc|indexSelect|index_elementwise|index_put|scatter|gather", re.IGNORECASE)


def profile_rows(fn):
    """(kernel name, device us, launches) of one fn() call, torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, device_us(e), e.count) for e in prof.key_averages() if device_us(e) > 0]


def pg_phase(dev, smi) -> None:
    """Phase 17: the pose graph on the card against the port's CPU path."""
    from visual_slam_tpu_torch.models import pose_graph as pg
    from visual_slam_tpu_torch.ops.kernels import seg_kernel
    from visual_slam_tpu_torch.utils.synthetic import big_pose_graph

    big, _ = big_pose_graph(5000, device="cpu")
    cases = [("5k SE3", pg.optimize, big, dict(n_iters=12, cg_iters=32)),
             ("5k Sim3", pg.optimize_sim3, sim3_of(big), dict(n_iters=12, cg_iters=32))]
    for name, fn, g_cpu, kw in cases:
        g_dev = to_device(g_cpu, dev)
        ref = fn(g_cpu, **kw)
        fn(g_dev, **kw)  # warm-up
        torch.cuda.synchronize()
        zero_kernel_counts()
        t0 = time.perf_counter()
        out = fn(g_dev, **kw)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)  # the second card call: warm
        launches = {k: kernel_counts()[k] for k in ("cam_reduce", "cam_expand")}
        again = fn(g_dev, **kw)
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"pose graph {name}: two card calls differ")
        per = kw["n_iters"] * (1 + kw["cg_iters"])
        if launches != {"cam_reduce": per, "cam_expand": per}:
            raise AssertionError(f"pose graph {name}: launches {launches}, expected {per} each")
        err = [(a.cpu() - b).abs().max().item() for a, b in zip(out[:-1], ref[:-1])]
        bars = [PG_R_ATOL, PG_T_ATOL, PG_LAM_ATOL][:len(err)]
        if not all(np.isfinite(e) and e <= b for e, b in zip(err, bars)):
            raise AssertionError(f"pose graph {name}: card vs CPU max errors {err}, bars {bars}")
        # Indexing kernels (index_add_, index_select, gathers, scatters): the
        # reduce plan's integer bookkeeping launches a few a call; a GN step
        # and a CG iteration launch none, so one GN step of one CG iteration
        # launches as many as the whole solve. Every call launches the same
        # kernels, so an indexing launch in the loop shows in every pair of
        # profiles; a pair that disagrees once and then agrees lost events
        # in the profiler and is taken again.
        for attempt in range(3):
            rows = profile_rows(lambda: fn(g_dev, **kw))
            one = profile_rows(lambda: fn(g_dev, n_iters=1, cg_iters=1))
            indexing = {k: c for k, _, c in rows if INDEXING.search(k)}
            one_indexing = {k: c for k, _, c in one if INDEXING.search(k)}
            if indexing == one_indexing:
                break
            log(f"[pose graph] {name}: profile pair {attempt + 1} disagrees on indexing kernels "
                f"(solve {indexing}, one step {one_indexing}); taking it again")
        else:
            raise AssertionError(f"pose graph {name}: indexing kernels in the GN/CG loop: {indexing}, "
                                 f"one GN step of one CG iteration: {one_indexing}")
        dev_ms = sum(r[1] for r in rows) / 1e3
        seg_ms = sum(r[1] for r in rows if "vslam_" in r[0] or "cam_" in r[0]) / 1e3
        K, N = g_cpu.R.shape[0], 2 * g_cpu.e_i.shape[0] + (2 * g_cpu.s_i.shape[0] if fn is pg.optimize else 0)
        log(f"[pose graph] {name}: K={K}, {N} slots, {kw['n_iters']} GN x {kw['cg_iters']} CG: card vs "
            f"CPU max |dR| {err[0]:.3g}, |dt| {err[1]:.3g}" + (f", |dlam| {err[2]:.3g}" if len(err) > 2 else "")
            + f"; cost {float(out[-1]):.6g} (CPU {float(ref[-1]):.6g}); two card calls bit-equal; "
            f"launches a call B4 {launches['cam_reduce']}, B5 {launches['cam_expand']}; indexing kernels "
            f"a call {sum(indexing.values())}, all in the reduce plan (as many at 1 GN x 1 CG)")
        log(f"[pose graph] {name}: {first_ms:.3f} ms a call (wall, warm, synchronised), {dev_ms:.3f} ms "
            f"device over {sum(r[2] for r in rows)} device ops (B4/B5 {seg_ms:.3f} ms): device busy share "
            f"{dev_ms / first_ms:.3f}; {smi}")
        for key, us, count in sorted(rows, key=lambda r: -r[1])[:4]:
            log(f"[pose graph]   {us / 1e3:8.4f} ms {count:5d}x  {key[:90]}")


def score_phase(dev, smi) -> None:
    """Phase 18: loop scoring on the card against the CPU."""
    from visual_slam_tpu_torch.models import loop_closure as lc

    rng = np.random.default_rng(18)
    K, F = 64, 1024
    db = rng.integers(0, 2**32, (K, F, 8), dtype=np.uint32)
    flips = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    cur = db[5] ^ (flips & (flips >> 1) & (flips >> 2) & (flips >> 3) & np.uint32(0x11111111))
    db_valid, cur_valid = rng.uniform(size=(K, F)) < 0.9, rng.uniform(size=F) < 0.95
    mask = np.ones(K, bool)
    mask[[9, 40]] = False
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (cur.view(np.int32), cur_valid, db.view(np.int32), db_valid, mask)]
    ref = lc.score_keyframes(*args, 48.0)
    dargs = [a.to(dev) for a in args]
    got = lc.score_keyframes(*dargs, 48.0)
    if not torch.equal(got.cpu(), ref) or int(ref[5]) < 500:
        raise AssertionError(f"loop scoring: card differs from the CPU (or no revisit hit: {int(ref[5])})")
    ms = cuda_ms(lambda: lc.score_keyframes(*dargs, 48.0), iters=20, warmup=3)
    dms, how = device_ms(lambda: lc.score_keyframes(*dargs, 48.0), iters=10)
    chunk = max(1, lc.SCORE_CHUNK_BYTES // (4 * F * F))
    log(f"[loop scoring] {K} keyframes x {F} features ({-(-K // chunk)} chunks of {chunk}): card equal to "
        f"the CPU; revisit score {int(ref[5])}, next best {int(np.sort(ref.numpy())[-2])}; {ms:.4f} ms a "
        f"call, {dms:.4f} ms device ({how}); {smi}")


def close_loop_phase(dev, smi) -> None:
    """Phase 19: Slam._close_loop on RingScene, card and CPU."""
    from visual_slam_tpu_torch.utils.synthetic import RingScene

    keys = ("loop_closures", "loop_verify_fail", "loop_rejected_warp", "loop_rejected_unsatisfied")
    for case, kw, handle in (("genuine", dict(drift_scale=1.15), (39, 0, 25, True)),
                             ("false", dict(drift_scale=1.12), (39, 20, 25, False))):
        res = {}
        for device in (dev, "cpu"):
            sc = RingScene(np.random.default_rng(7), device=device, **kw)
            m = sc.slam.map
            before = (m.kf_R.copy(), m.kf_t.copy(), m.pt_xyz.copy())
            err0 = sc.endpoint_error()
            h = sc.verify_handle(*handle)
            if device != "cpu":
                torch.cuda.synchronize()
                zero_kernel_counts()
            t0 = time.perf_counter()
            sc.slam._close_loop(h)
            if device != "cpu":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: kernel_counts()[k] for k in ("cam_reduce", "cam_expand")}
            st = sc.slam.stats
            res[str(device)] = (tuple(st[k] for k in keys), st["loop_accepted"] + st["loop_rejected_detail"],
                                sc, before, err0, sc.endpoint_error(), wall, counts)
        (dec, det, sc, before, err0, err1, wall, counts), (cdec, cdet, csc, *_ ) = res[str(dev)], res["cpu"]
        if dec != cdec or [sorted(d) for d in det] != [sorted(d) for d in cdet]:
            raise AssertionError(f"close loop {case}: card {dec} {det}, CPU {cdec} {cdet}")
        m = sc.slam.map
        if case == "genuine":
            if dec[0] != 1 or not err1 < 0.5 * err0:
                raise AssertionError(f"close loop {case}: {dec}, endpoint error {err0} -> {err1}")
            dk = max(float(np.abs(m.kf_t - csc.slam.map.kf_t).max()),
                     float(np.abs(m.kf_R - csc.slam.map.kf_R).max()))
        else:
            if dec[0] != 0 or dec[2] + dec[3] != 1:
                raise AssertionError(f"close loop {case}: {dec}")
            if not all(np.array_equal(a, b) for a, b in zip((m.kf_R, m.kf_t, m.pt_xyz), before)):
                raise AssertionError(f"close loop {case}: the map changed")
            dk = 0.0
        log(f"[close loop] {case}: {dict(zip(keys, dec))} on card and CPU, records {det}; endpoint "
            f"error {err0:.4f} -> {err1:.4f} m; keyframe poses card vs CPU within {dk:.3g}"
            f"{'' if case == 'genuine' else ', map bit for bit unchanged'}; {1e3 * wall:.1f} ms, "
            f"launches B4 {counts['cam_reduce']} B5 {counts['cam_expand']}; {smi}")


def revisit_launches_wanted(slam, n_frames) -> tuple[dict, tuple]:
    """Launches of an RGB-D run with loop closure: B1/B3 once a frame; per
    BA step B4 10 and B5 23 (phase 6); per pose-graph solve (pgo_iters GN
    x 33) B4 and B5 each; B5 once more per warp-validation reprojection
    (two per closure that reaches it). Returns (launches, (BA steps,
    pose-graph solves, warp validations))."""
    st = slam.stats
    n_ba = (st["ba_runs"] + st["ba_dropped_stale"] + st["ba_rejected"] + st["ba_discarded_loop"]
            + (slam._pending_ba is not None))
    n_pg = st["loop_closures"] + st["loop_rejected_unsatisfied"] + st["loop_rejected_warp"]
    n_warp = st["loop_closures"] + st["loop_rejected_warp"]
    it, pg_calls = slam.cfg.ba.iters, slam.cfg.loop.pgo_iters * 33
    want = {"detect_blur": n_frames, "patch": n_frames, "cam_reduce": it * n_ba + pg_calls * n_pg,
            "cam_expand": (2 * it + 3) * n_ba + pg_calls * n_pg + 2 * n_warp}
    return want, (n_ba, n_pg, n_warp)


def revisit_phase(dev, smi, frames) -> tuple[dict, float, list]:
    """Phase 20: the RGB-D SLAM loop on the revisiting scene, twice.
    Returns the first run's launches, wall seconds and host clock after
    each frame."""
    from visual_slam_tpu_torch.config import SlamConfig
    from visual_slam_tpu_torch.utils.evaluate import ate_rmse
    from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

    gt = SyntheticRGBDScene(REVISIT_FRAMES, trajectory="revisit").ground_truth()
    runs, stamps = [], []
    for k in range(2):
        slam, wall, launches = run_slam(frames, SlamConfig(use_depth=True), dev, None if k else stamps)
        runs.append((slam, wall, launches))
    (slam, wall, launches), (slam2, wall2, launches2) = runs
    st = slam.stats
    idxs, est = slam.positions()
    if len(idxs) != REVISIT_FRAMES or not np.isfinite(est).all():
        raise AssertionError(f"revisit: {len(idxs)} poses, finite {np.isfinite(est).all()}")
    ate, _ = ate_rmse(est, gt[idxs, :3, 3], align_scale=False)
    want, (n_ba, n_pg, n_warp) = revisit_launches_wanted(slam, REVISIT_FRAMES)
    if launches != want:
        raise AssertionError(f"revisit: launches {launches}, expected {want}")
    summ = slam.timers.summary()
    loop_t = summ.get("kf_loop", {})
    kfs = [f.frame_idx for f in slam.trajectory if f.is_keyframe]
    log(f"[revisit] {REVISIT_FRAMES} frames: {REVISIT_FRAMES / wall:.2f} frames/s ({wall:.3f} s wall; "
        f"second run {REVISIT_FRAMES / wall2:.2f}), ATE {ate:.6f} m (limit {ATE_LIMIT_M}), "
        f"{st['track_failures']} track failures, {st['keyframes']} keyframes at {kfs}; {smi}")
    log(f"[revisit] closures: {st['loop_closures']} accepted {st['loop_accepted']}; rejected: "
        f"covisibility {st['loop_rejected_covis']}, verification {st['loop_verify_fail']} (best "
        f"{st['loop_verify_best']} inliers), unsatisfied edge {st['loop_rejected_unsatisfied']}, warp "
        f"{st['loop_rejected_warp']} {st['loop_rejected_detail']}; {st['loop_candidates']} candidates "
        f"verified; BAs applied {st['ba_runs']}, dropped {st['ba_dropped_stale']}, rejected "
        f"{st['ba_rejected']}, discarded by a closure {st['ba_discarded_loop']}")
    log(f"[revisit] launches {launches} (= {n_ba} BA steps, {n_pg} pose-graph solves, {n_warp} warp "
        f"validations); kf_loop {loop_t.get('calls', 0)} calls, median {loop_t.get('median_ms', 0):.3f} ms, "
        f"total {sum(slam.timers.ms.get('kf_loop', [])):.3f} ms; median track "
        f"{summ['track']['median_ms']:.3f} ms, BA solve {summ['ba_solve']['median_ms']:.3f} ms")
    if st["loop_closures"] < 1 or st["track_failures"] != 0 or ate >= ATE_LIMIT_M:
        raise AssertionError(f"revisit: {st['loop_closures']} closures, {st['track_failures']} failures, "
                             f"ATE {ate} m")
    same = (st == slam2.stats and launches == launches2
            and len(slam.trajectory) == len(slam2.trajectory)
            and all((a.frame_idx, a.is_keyframe) == (b.frame_idx, b.is_keyframe)
                    and np.array_equal(a.R_cw, b.R_cw) and np.array_equal(a.t_cw, b.t_cw)
                    for a, b in zip(slam.trajectory, slam2.trajectory))
            and np.array_equal(slam.map.pt_xyz, slam2.map.pt_xyz))
    if not same:
        raise AssertionError("revisit: the second card run differs from the first")
    log("[revisit] second card run: the same history, stats and launches, poses and landmarks bit-equal")
    return launches, wall, stamps


def batched_phase(dev, smi, frames) -> dict:
    """Phase 21, config #3: run_batched over 4 distinct windows of the
    revisit frames, each held to its own run_sequence on the card."""
    from visual_slam_tpu_torch.config import SlamConfig
    from visual_slam_tpu_torch.multi import run_batched
    from visual_slam_tpu_torch.pipeline import run_sequence
    from visual_slam_tpu_torch.utils.dataset import WindowView
    from visual_slam_tpu_torch.utils.evaluate import ate_rmse
    from visual_slam_tpu_torch.utils.scene import FrameSequence, SyntheticRGBDScene

    gt = SyntheticRGBDScene(REVISIT_FRAMES, trajectory="revisit").ground_truth()
    base = FrameSequence(frames, gt)
    views = [WindowView(base, off, length=BATCH_LENGTH, reverse=rev) for off, rev in BATCH_WINDOWS]
    cfg = SlamConfig(use_depth=True)
    torch.cuda.synchronize()
    zero_kernel_counts()
    t0 = time.perf_counter()
    slams = run_batched(views, cfg, device=dev)
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, kernel_counts()
    singles = []
    for view in views:
        t0 = time.perf_counter()
        single = run_sequence(view, cfg, device=dev)
        torch.cuda.synchronize()
        singles.append((single, time.perf_counter() - t0))
    n_ba = n_pg = n_warp = 0
    centres = []
    for b, (view, slam, (single, single_wall)) in enumerate(zip(views, slams, singles)):
        st = dict(slam.stats)
        if st.pop("frontend_devices") != 1:
            raise AssertionError(f"batched: sequence {b} ran its front-end on more than one card")
        same = (st == single.stats and len(slam.trajectory) == len(single.trajectory)
                and all((a.frame_idx, a.is_keyframe, a.n_tracked) == (c.frame_idx, c.is_keyframe, c.n_tracked)
                        and np.array_equal(a.R_cw, c.R_cw) and np.array_equal(a.t_cw, c.t_cw)
                        for a, c in zip(slam.trajectory, single.trajectory))
                and np.array_equal(slam.map.pt_xyz, single.map.pt_xyz))
        if not same:
            raise AssertionError(f"batched: sequence {b} differs from its own run_sequence")
        idxs, est = slam.positions()
        ate, _ = ate_rmse(est, view.ground_truth()[idxs, :3, 3], align_scale=False)
        kfs = [f.frame_idx for f in slam.trajectory if f.is_keyframe]
        log(f"[batched] sequence {b} (offset {view.offset}, reversed {view.reverse}): ATE {ate:.6f} m, "
            f"{st['track_failures']} track failures, init frame {st['init_frame']}, keyframes at {kfs}, "
            f"{st['ba_runs']} BAs applied, {st['loop_closures']} closures; history, stats, poses and "
            f"landmarks bit-equal to its run_sequence ({BATCH_LENGTH / single_wall:.2f} frames/s alone)")
        if len(idxs) != BATCH_LENGTH or st["track_failures"] != 0 or not ate < ATE_LIMIT_M:
            raise AssertionError(f"batched: sequence {b}: {len(idxs)} poses, {st['track_failures']} "
                                 f"failures, ATE {ate} m")
        n_ba += (st["ba_runs"] + st["ba_dropped_stale"] + st["ba_rejected"] + st["ba_discarded_loop"]
                 + (slam._pending_ba is not None))
        n_pg += st["loop_closures"] + st["loop_rejected_unsatisfied"] + st["loop_rejected_warp"]
        n_warp += st["loop_closures"] + st["loop_rejected_warp"]
        centres.append(est)
    apart = min(np.abs(centres[a] - centres[b]).max() for a in range(4) for b in range(a + 1, 4))
    if not apart > 1e-3:
        raise AssertionError(f"batched: two sequences' camera centres are only {apart} m apart")
    it, pg_calls = cfg.ba.iters, cfg.loop.pgo_iters * 33
    want = {"detect_blur": BATCH_LENGTH, "patch": BATCH_LENGTH,
            "cam_reduce": it * n_ba + pg_calls * n_pg,
            "cam_expand": (2 * it + 3) * n_ba + pg_calls * n_pg + 2 * n_warp}
    if launches != want:
        raise AssertionError(f"batched: launches {launches}, expected {want}")
    n_all = len(views) * BATCH_LENGTH
    single_fps = [BATCH_LENGTH / w for _, w in singles]
    H, W = frames[0][1].shape
    log(f"[batched] {len(views)} sequences x {BATCH_LENGTH} frames at {W}x{H}: {n_all / wall:.2f} frames/s "
        f"aggregate ({wall:.3f} s wall) vs single runs {', '.join(f'{f:.2f}' for f in single_fps)} frames/s "
        f"({n_all / sum(w for _, w in singles):.2f} aggregate in turn); camera centres of two sequences "
        f">= {apart:.4f} m apart; launches {launches} ({n_ba} BA steps); {smi}")
    return launches


# Phase 22: the sharded solvers. (a) An NCCL world of one rank in this
# process is the unsharded solve, bit for bit. (b) Four gloo ranks on the one
# card against the unsharded card solve, at the JAX tests' bars between a
# sharded and an unsharded solve: config #5 tests/test_ba_large.py:33-45,
# the 5k graph tests/test_pose_graph.py:203-221. Config #5's landmarks are
# held to the unsharded solve's own float32 spread instead of X 1e-3: five LM
# iterations leave weakly observed landmarks free along their rays, and the
# unsharded solve, solved again from translations scaled by 1 + PERTURB,
# moves the worst of them by tenths of a metre (this phase prints how far),
# so no two float32 orders of the camera sums agree to 1e-3 there. The fleet's
# per-landmark distance from the unsharded X, at its median, 99th percentile
# and maximum, stays within X_SPREAD_FACTOR x the same statistic of that
# spread.
FLEET_RANKS = 4
LARGE_COST_RTOL, LARGE_T_ATOL = 1e-2, 1e-3
PERTURB, X_SPREAD_FACTOR, X_QUANTILES = 1e-7, 2.0, (0.5, 0.99, 1.0)
PG5K_T_ATOL, PG5K_R_ATOL, PG5K_COST_RTOL = 2e-3, 2e-4, 1e-3
PG5K = dict(n_iters=12, cg_iters=32)
CLI_FRAMES = 60  # phase 23: phase 6's frames, written to disk
# Phase 23's subprocess: the command line run as `python -m
# visual_slam_tpu_torch.pipeline ARGS` runs it (runpy, as __main__), with
# every kernel count set to 0 just before, and that run's counts printed
# after its JSON line, on a last line of their own.
CLI_RUNNER = ("import json, runpy, chip_smoke\n"
              "chip_smoke.zero_kernel_counts()\n"
              "runpy.run_module('visual_slam_tpu_torch.pipeline', run_name='__main__', alter_sys=True)\n"
              "print(json.dumps({'launches': chip_smoke.kernel_counts()}))\n")


def launch_dict(reduce, expand) -> dict:
    """A path's launches of every kernel, for one that runs only B4/B5."""
    return {"detect_blur": 0, "patch": 0, "cam_reduce": int(reduce), "cam_expand": int(expand)}


def fleet_run(jobs, out_dir) -> tuple[list, dict, float]:
    """Spawn FLEET_RANKS gloo ranks on the card through the port's fleet
    launcher; every rank runs `jobs`. Returns (the ranks' log lines,
    {job: [rank npz dicts]}, wall seconds)."""
    import os

    from visual_slam_tpu_torch.parallel import multihost

    os.makedirs(out_dir)
    spec = os.path.join(out_dir, "jobs.json")
    with open(spec, "w") as f:
        json.dump({"jobs": jobs}, f)
    t0 = time.perf_counter()
    logs = multihost.spawn_worker_fleet(
        FLEET_RANKS, ["-m", "visual_slam_tpu_torch.parallel.worker", "--backend", "gloo",
                      "--device", "cuda", spec, out_dir], timeout_s=600)
    wall = time.perf_counter() - t0
    out = {j["name"]: [dict(np.load(os.path.join(out_dir, f"{j['name']}.r{r}.npz")))
                       for r in range(FLEET_RANKS)] for j in jobs}
    lines = [ln for log_ in logs for ln in log_.splitlines() if ln.startswith("rank ")]
    return lines, out, wall


def sharded_phase(dev, smi) -> tuple[dict, dict]:
    """Phase 22: the sharded solvers on the card. Returns (launches by path,
    the per-rank B4/B5 timings at the 4-rank pose graph's shapes)."""
    import os
    import tempfile

    import torch.distributed as dist
    from visual_slam_tpu_torch.models import ba, ba_large
    from visual_slam_tpu_torch.models import pose_graph as pg
    from visual_slam_tpu_torch.ops.kernels import seg_kernel
    from visual_slam_tpu_torch.parallel import multihost, sharded_ba, sharded_pg
    from visual_slam_tpu_torch.utils.synthetic import arc_problem, big_pose_graph, build_loop_map

    lap = [time.perf_counter()]
    # (a) NCCL, a world of one rank, here
    p16, _ = arc_problem(16, 2048, 0.5, 0.02, 0.03, seed=1, device=dev)
    prob5, gt5 = build_loop_map(CONFIG5["K"], CONFIG5["P"], CONFIG5["Q"], seed=0, device=dev)
    g5k, _ = big_pose_graph(5000, device=dev)
    n5, cg5, lam5 = CONFIG5["n_iters"], CONFIG5["cg_iters"], CONFIG5["lm_lambda"]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{multihost.free_port()}",
                            world_size=1, rank=0)
    group = multihost.global_group()
    cases = {
        "nccl1_arc_chol": (lambda: ba.optimize(p16, 10, 12, solver="chol"),
                           lambda: sharded_ba.optimize_sharded(p16, group, 10, 12, solver="chol")),
        "nccl1_arc_cg": (lambda: ba.optimize(p16, 10, 12, solver="cg"),
                         lambda: sharded_ba.optimize_sharded(p16, group, 10, 12, solver="cg")),
        "nccl1_config5": (lambda: ba_large.optimize(prob5, n5, cg5, init_lambda=lam5),
                          lambda: sharded_ba.optimize_large_sharded(prob5, group, n5, cg5,
                                                                    init_lambda=lam5)),
        "nccl1_pg5k": (lambda: pg.optimize(g5k, **PG5K),
                       lambda: sharded_pg.optimize_sharded(g5k, group, **PG5K)),
    }
    by_path, unsharded = {}, {}
    try:
        for path, (plain_fn, sharded_fn) in cases.items():
            res = []
            for fn in (plain_fn, sharded_fn):
                torch.cuda.synchronize()
                zero_kernel_counts()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                res.append((out, time.perf_counter() - t0, kernel_counts()))
            (u, u_s, u_n), (s, s_s, s_n) = res
            flat = lambda o: [o[0], o[1], o[-1]] if path == "nccl1_pg5k" else [  # noqa: E731
                o[0].R, o[0].t, o[0].X, o[1]]
            if not all(torch.equal(a, b) for a, b in zip(flat(u), flat(s))) or u_n != s_n:
                raise AssertionError(f"sharded {path}: a world of one rank is not the unsharded "
                                     f"solve (launches {s_n} vs {u_n})")
            if not (s_n["cam_reduce"] > 0 and s_n["cam_expand"] > 0):
                raise AssertionError(f"sharded {path}: no B4/B5 launch ({s_n})")
            by_path[path] = s_n
            unsharded[path] = [t.cpu().numpy() for t in flat(u)]
            log(f"[sharded] (a) {path}: NCCL world of 1 rank bit-equal to the unsharded solve "
                f"(cost {float(flat(s)[-1])!r}), launches B4 {s_n['cam_reduce']} B5 "
                f"{s_n['cam_expand']} in both; {1e3 * s_s:.2f} ms vs {1e3 * u_s:.2f} ms unsharded")
    finally:
        dist.destroy_process_group()
    t_err0 = float(np.abs(prob5.t.cpu().numpy() - gt5[1]).max())
    pert, _ = ba_large.optimize(prob5._replace(t=prob5.t * (1 + PERTURB)), n5, cg5, init_lambda=lam5)
    spread = np.quantile(np.abs(pert.X.cpu().numpy() - unsharded["nccl1_config5"][2]).max(1),
                         X_QUANTILES)
    log(f"[sharded] config #5's own spread: solved from t x (1 + {PERTURB}), X moves by "
        f"{spread[0]:.3g} / {spread[1]:.3g} / {spread[2]:.3g} (median / 99th percentile / max), t by "
        f"{float((pert.t - prob5.t.new_tensor(unsharded['nccl1_config5'][1])).abs().max()):.3g}")
    del p16, prob5, g5k, pert
    torch.cuda.empty_cache()
    lap.append(time.perf_counter())

    # (b) gloo, FLEET_RANKS ranks on the one card, twice
    jobs = [dict(name="config5", kind="large",
                 problem=dict(synthetic="loop_map", K=CONFIG5["K"], P=CONFIG5["P"], Q=CONFIG5["Q"]),
                 opts=dict(n_iters=n5, cg_iters=cg5, init_lambda=lam5), repeat=2),
            dict(name="pg5k", kind="pg", problem=dict(synthetic="big_pose_graph", K=5000),
                 opts=PG5K, repeat=2)]
    with tempfile.TemporaryDirectory() as tmp:
        runs = [fleet_run(jobs, os.path.join(tmp, f"run{k}")) for k in range(2)]
    for name, ref_path in (("config5", "nccl1_config5"), ("pg5k", "nccl1_pg5k")):
        (_, a, _), (_, b, _) = runs
        keys = ("R", "t", "X", "cost") if name == "config5" else ("R", "t", "cost")
        for r in range(FLEET_RANKS):
            if not all(np.array_equal(a[name][r][k], b[name][r][k]) for k in keys):
                raise AssertionError(f"sharded fleet {name}: rank {r} differs between two runs")
            if not all(np.array_equal(a[name][r][k], a[name][0][k]) for k in ("R", "t", "cost")):
                raise AssertionError(f"sharded fleet {name}: rank {r} ended elsewhere than rank 0")
        ranks = a[name]
        ref = unsharded[ref_path]
        cost, ref_cost = float(ranks[0]["cost"]), float(ref[-1])
        if name == "config5":
            dX = np.quantile(np.abs(np.concatenate([r["X"] for r in ranks]) - ref[2]).max(1),
                             X_QUANTILES)
            errs = dict(t=np.abs(ranks[0]["t"] - ref[1]).max(),
                        cost=abs(cost - ref_cost) / max(1.0, ref_cost),
                        **{f"X_q{q}": d for q, d in zip(X_QUANTILES, dX)})
            bars = dict(t=LARGE_T_ATOL, cost=LARGE_COST_RTOL,
                        **{f"X_q{q}": X_SPREAD_FACTOR * d for q, d in zip(X_QUANTILES, spread)})
            t_err = float(np.abs(ranks[0]["t"] - gt5[1]).max())
            extra = f"; max |t err| {t_err0:.5f} -> {t_err:.5f} m"
        else:
            errs = dict(t=np.abs(ranks[0]["t"] - ref[1]).max(), R=np.abs(ranks[0]["R"] - ref[0]).max(),
                        cost=abs(cost - ref_cost) / max(1.0, abs(ref_cost)))
            bars = dict(t=PG5K_T_ATOL, R=PG5K_R_ATOL, cost=PG5K_COST_RTOL)
            extra = ""
        if not all(np.isfinite(errs[k]) and errs[k] <= bars[k] for k in bars):
            raise AssertionError(f"sharded fleet {name}: against the unsharded card solve {errs}, "
                                 f"bars {bars}")
        by_path[f"gloo{FLEET_RANKS}_{name}"] = launch_dict(
            sum(r["reduce_launches"] for r in ranks), sum(r["expand_launches"] for r in ranks))
        if not all(r["reduce_launches"] > 0 and r["expand_launches"] > 0 for r in ranks):
            raise AssertionError(f"sharded fleet {name}: a rank launched no B4 or no B5")
        n_it = jobs[0]["opts"]["n_iters"] if name == "config5" else PG5K["n_iters"]
        log(f"[sharded] (b) {name}, {FLEET_RANKS} gloo ranks on one card: cost {cost!r} (unsharded "
            f"{ref_cost!r}); against the unsharded solve "
            + ", ".join(f"{k} {float(v):.3g} (bar {bars[k]})" for k, v in errs.items())
            + f"; two fleet runs bit-equal, every rank on rank 0's poses and cost{extra}")
        for r, o in enumerate(ranks):
            if int(o["allreduce_spans"]) != int(o["allreduce_calls"]):
                raise AssertionError(f"sharded fleet {name}: rank {r}'s profile holds "
                                     f"{int(o['allreduce_spans'])} all-reduce spans for "
                                     f"{int(o['allreduce_calls'])} calls")
            ar_ms, it_ms = float(o["allreduce_ms"]) / n_it, 1e3 * float(o["profiled_wall_s"]) / n_it
            log(f"[sharded] (b) {name} rank {r}: warm {n_it / o['walls'][1]:.3f} iters/s (first solve "
                f"{o['walls'][0]:.3f} s, warm {o['walls'][1]:.4f} s), peak {o['peak_mem_bytes'] / 1e9:.3f} "
                f"GB, B4 {int(o['reduce_launches'])} B5 {int(o['expand_launches'])}, all-reduce "
                f"{int(o['allreduce_calls'])} calls, {float(o['allreduce_bytes']) / n_it:.0f} B an "
                f"iteration; a profiled solve: {ar_ms:.3f} ms an iteration inside all-reduces "
                f"(torch.profiler's gloo:all_reduce spans: peers' waits and this rank's queued "
                f"kernels included) of {it_ms:.3f} ms, share {ar_ms / it_ms:.3f}")
    log(f"[sharded] (b) the {FLEET_RANKS} ranks share one card's SMs and the host's cores: their times "
        f"show the protocol's cost (start-up, host-staged gloo all-reduces), not scaling; fleet "
        f"runs {runs[0][2]:.1f} s and {runs[1][2]:.1f} s wall, ranks' start-up included; {smi}")
    lap.append(time.perf_counter())

    # B4 and B5 at rank 0's shapes of the 4-rank pose graph, beside
    # index_add_ / index_select and their bounds
    g_cpu, _ = big_pose_graph(5000, device="cpu")
    local = sharded_pg.shard_graph(sharded_pg.pad_edges(g_cpu, FLEET_RANKS), 0, FLEET_RANKS)
    ids = torch.cat([local.e_i, local.e_j, local.s_i, local.s_j]).to(torch.int32).to(dev)
    K, N = g_cpu.R.shape[0], ids.shape[0]
    rng = np.random.default_rng(22)
    times = {}
    for name, C in (("B4", 42), ("B4", 6), ("B5", 12), ("B5", 6)):
        if name == "B4":
            d = torch.from_numpy(rng.normal(size=(C, N)).astype(np.float32)).to(dev)
            plan = seg_kernel.reduce_plan(ids, K)
            kernel_fn, plain_fn, library_fn = (lambda: seg_kernel.cam_reduce(d, ids, K, plan),
                                               lambda: seg_kernel.cam_reduce_torch(d, ids, K),
                                               library_reduce(d, ids, K))
            torch.testing.assert_close(kernel_fn(), plain_fn(), rtol=REDUCE_RTOL, atol=REDUCE_ATOL)
            bound = bound_ms(4 * (C * N + N + C * K), C * N)
        else:
            x = torch.from_numpy(rng.normal(size=(C, K)).astype(np.float32)).to(dev)
            kernel_fn, plain_fn, library_fn = (lambda: seg_kernel.cam_expand(x, ids),
                                               lambda: seg_kernel.cam_expand_torch(x, ids),
                                               library_expand(x, ids))
            if not torch.equal(kernel_fn(), plain_fn()):
                raise AssertionError(f"B5 C={C} at the sharded pose graph's shape: not bit-equal")
            bound = bound_ms(4 * (C * K + N + C * N), 0)
        p1, k1, k2, p2 = (queued_ms(f, iters=50) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        kms, pms, lms = min(k1, k2), min(p1, p2), queued_ms(library_fn, iters=50)
        times[(name, C, N, K)] = (kms, pms, lms, bound)
        log(f"[sharded] {name} C={C} N={N} K={K} (rank 0 of the {FLEET_RANKS}-rank 5k pose graph): "
            f"kernel {kms:.4f} ms, plain {pms:.4f} ms, library {lms:.4f} ms (queued events); bound "
            f"{bound[0]:.5f} ms ({bound[1]}): kernel at {bound[0] / kms:.3f} of its bound; kernel "
            f"{'beats' if kms < lms else 'LOSES to'} the library call; {smi}")
    lap.append(time.perf_counter())
    secs = np.diff(lap)
    log(f"[sharded] phase 22 took {lap[-1] - lap[0]:.1f} s: (a) {secs[0]:.1f}, (b) two fleet runs "
        f"{secs[1]:.1f}, kernel timings {secs[2]:.1f}")
    return by_path, times


def cli_phase(dev, smi, frames, gt) -> dict:
    """Phase 23: the command line as a subprocess on the card over phase
    6's frames written to disk, against run_sequence in this process.
    Returns the command line's own kernel launches."""
    import importlib.util
    import os
    import tempfile

    from visual_slam_tpu_torch import native
    from visual_slam_tpu_torch.config import size_config_for
    from visual_slam_tpu_torch.pipeline import run_sequence
    from visual_slam_tpu_torch.utils import checkpoint, g2o_io
    from visual_slam_tpu_torch.utils.dataset import ICLNUIMDataset, write_icl_nuim
    from visual_slam_tpu_torch.utils.evaluate import ate_rmse

    t_start = time.perf_counter()
    plots = importlib.util.find_spec("matplotlib") is not None
    log(f"[cli] matplotlib {'importable: --export-traj and --live-dump on' if plots else 'absent: --export-traj and --live-dump off'}")
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "icl")
        t0 = time.perf_counter()
        write_icl_nuim(data, frames[:CLI_FRAMES], gt[:CLI_FRAMES])
        write_s = time.perf_counter() - t0
        art = {k: os.path.join(tmp, v) for k, v in (("ply", "map.ply"), ("g2o", "graph.g2o"),
                                                    ("ckpt", "map.npz"), ("traj", "traj.png"),
                                                    ("live", "live"))}
        cmd = [sys.executable, "-c", CLI_RUNNER, "--data", data, "--frames",
               str(CLI_FRAMES), "--rgbd", "--pose-graph", "--export-ply", art["ply"], "--export-g2o",
               art["g2o"], "--checkpoint", art["ckpt"]]
        if plots:
            cmd += ["--export-traj", art["traj"], "--live-dump", art["live"]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"cli: exit {res.returncode}:\n{res.stderr[-3000:]}")
        *_, out_line, launches_line = res.stdout.strip().splitlines()
        out, launches = json.loads(out_line), json.loads(launches_line)["launches"]
        cfg = size_config_for(CLI_FRAMES)
        cfg.use_depth = True
        ds = ICLNUIMDataset(data)
        torch.cuda.synchronize()
        zero_kernel_counts()
        t0 = time.perf_counter()
        slam = run_sequence(ds, cfg, 0, CLI_FRAMES, device=dev)
        slam.optimize_pose_graph()
        torch.cuda.synchronize()
        wall, here_launches = time.perf_counter() - t0, kernel_counts()
        idxs, est = slam.positions()
        ate, _ = ate_rmse(est, ds.ground_truth()[idxs, :3, 3], align_scale=False)
        m, traj = checkpoint.load_map(art["ckpt"])
        same = ((out["frames"], out["keyframes"], out["init_frame"], out["points"])
                == (len(idxs), slam.stats["keyframes"], slam.stats["init_frame"],
                    int(slam.map.pt_valid.sum())) and np.array_equal(traj, est)
                and out["ate_rmse_m"] == ate and launches == here_launches)
        if not same:
            raise AssertionError(f"cli: {out} (launches {launches}) differs from run_sequence in this "
                                 f"process (keyframes {slam.stats['keyframes']}, init "
                                 f"{slam.stats['init_frame']}, ATE {ate}, centres equal "
                                 f"{np.array_equal(traj, est)}, launches {here_launches})")
        for name in ("kf_R", "kf_t", "kf_valid", "kf_frame_idx", "kf_scale_meas", "pt_xyz", "pt_desc",
                     "pt_valid", "pt_views", "obs_cam", "obs_pt", "obs_uv", "obs_depth", "obs_valid",
                     "n_kf", "n_pt", "n_obs"):
            if not np.array_equal(getattr(m, name), getattr(slam.map, name)):
                raise AssertionError(f"cli: the checkpoint's {name} differs from the run's map")
        poses, points, _ = g2o_io.load_pose_graph(art["g2o"])
        kf = np.where(slam.map.kf_valid)[0]
        g2o_err = max(max(np.abs(poses[int(k)][0] - slam.map.kf_R[k].T).max(),
                          np.abs(poses[int(k)][1] + slam.map.kf_R[k].T @ slam.map.kf_t[k]).max())
                      for k in kf)
        if sorted(poses) != list(kf) or len(points) != out["points"] or not g2o_err < 1e-6:
            raise AssertionError(f"cli: g2o file: {len(poses)} poses for {len(kf)} keyframes, "
                                 f"{len(points)} points, max pose error {g2o_err}")
        with open(art["ply"]) as f:
            head, body = f.read().split("end_header\n")
        if f"element vertex {out['points']}" not in head or len(body.splitlines()) != out["points"]:
            raise AssertionError("cli: the PLY file's vertices are not the valid points")
        if plots and not (os.path.getsize(art["traj"]) > 0
                          and os.path.exists(os.path.join(art["live"], "state.json"))):
            raise AssertionError("cli: no trajectory plot or live dump")
    if not (out["ate_rmse_m"] < ATE_LIMIT_M and launches["cam_reduce"] > 0
            and launches["detect_blur"] == launches["patch"] == CLI_FRAMES):
        raise AssertionError(f"cli: ATE {out['ate_rmse_m']}, launches {launches}")
    log(f"[cli] {CLI_FRAMES} frames at 640x480 written in {write_s:.1f} s and read by "
        f"{'the native loader' if native.available() else 'PIL (no native loader: ' + str(native.build_error) + ')'}; "
        f"the command line in {cli_s:.1f} s (process start included): {json.dumps(out)}")
    log(f"[cli] equal to run_sequence + optimize_pose_graph here ({CLI_FRAMES / wall:.2f} frames/s): "
        f"keyframes {out['keyframes']}, init frame {out['init_frame']}, centres bit-equal, ATE "
        f"{ate:.6f} m; checkpoint = the run's map, g2o poses within {g2o_err:.2g}, PLY {out['points']} "
        f"vertices; the command line's launches {launches}, the same here; phase 23 took {time.perf_counter() - t_start:.1f} s; {smi}")
    return launches


PIPE_DEPTH = 8  # run_pipelined's default
PIPE_RGBD_ATOL = 1e-3  # RGB-D centres, card vs CPU (the serial bar, phase 6 / the card tests)
PIPE_MONO_ATOL = 1e-4  # monocular centres, card vs CPU, until the second BA applies
# Profiled windows [k0, k1) of stream positions, multiples of the pipelined
# driver's 4-frame blocks, in each scene's tracking phase.
PROFILE_WINDOWS = {"RGB-D": (24, 36), "mono": (64, 76), "revisit": (64, 76)}


class RecordedTrajectory(list):
    """A Slam's trajectory that also notes, for each frame, the applied-BA
    count when its pose was recorded (the port appends or, for a
    backfilled frame, inserts)."""

    def __init__(self, slam):
        super().__init__()
        self.slam, self.ba_at = slam, {}

    def append(self, fr):
        self.ba_at[fr.frame_idx] = self.slam.stats["ba_runs"]
        super().append(fr)

    def insert(self, k, fr):
        self.ba_at[fr.frame_idx] = self.slam.stats["ba_runs"]
        super().insert(k, fr)


def pipelined_run(frames, cfg, dev, stamps=None):
    """run_pipelined at PIPE_DEPTH, every kernel count set to 0 just before
    and read just after. Returns (slam, wall seconds, launches, prof).
    `stamps`, a list, gets the host clock after each frame."""
    from visual_slam_tpu_torch.pipeline import Slam, run_pipelined

    slam = Slam(cfg, device=dev)
    slam.trajectory = RecordedTrajectory(slam)
    prof = {}
    on_frame = None if stamps is None else (lambda sl, i: stamps.append(time.perf_counter()))
    if slam.device.type == "cuda":
        torch.cuda.synchronize()
    zero_kernel_counts()
    t0 = time.perf_counter()
    run_pipelined(slam, iter(frames), PIPE_DEPTH, prof=prof, on_frame=on_frame)
    if slam.device.type == "cuda":
        torch.cuda.synchronize()
    return slam, time.perf_counter() - t0, kernel_counts(), prof


def driver_cost(frames, cfg, dev, pipelined, k0):
    """One more run of a driver over `frames`, under torch's sync-debug mode,
    with torch.profiler (the card's activity) on from stream position `k0`
    to the last frame's dispatch: the kernels' device ms in that window, and
    the synchronising calls, split into the frames before the map exists
    (init attempts) and the rest (tracked frames, with their keyframes and
    BAs). A run over a prefix of a scene is that scene's run up to there."""
    from visual_slam_tpu_torch.pipeline import Slam, run_pipelined

    slam = Slam(cfg, device=dev)
    marks = []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    # The pipelined driver dispatches its frames 4 at a time (one stacked
    # copy a block): only every 4th mark follows a dispatch.
    step = 4 if pipelined else 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            n_syncs = lambda: sum("synchroniz" in str(w.message) for w in caught)  # noqa: E731

            def on_frame(sl, i):
                marks.append((sl.initialized, n_syncs()))
                if len(marks) == k0:
                    prof.start()
                elif len(marks) == len(frames):
                    prof.stop()

            if pipelined:
                run_pipelined(slam, iter(frames), PIPE_DEPTH, on_frame=on_frame)
            else:
                for i, gray, depth in frames:
                    slam.process(i, gray, depth)
                    on_frame(slam, i)
            torch.cuda.synchronize()
            total = n_syncs()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # The raw trace: key_averages() would build every event's tree first.
    t0 = time.perf_counter()
    dev_ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6
    read_s = time.perf_counter() - t0
    before = [(k + 1, n) for k, (ok, n) in enumerate(marks) if not ok and (k + 1) % step == 0]
    n_init, init_syncs = before[-1] if before and not cfg.use_depth else (0, 0)
    n_tracked = len(slam.trajectory) - (1 if cfg.use_depth else 2)
    return dict(device_ms=dev_ms, read_s=read_s, syncs=total, init_attempts=n_init,
                syncs_per_init=init_syncs / n_init if n_init else None,
                syncs_per_tracked=(total - init_syncs) / max(n_tracked, 1))


def same_run(a, b) -> bool:
    """Two runs bit for bit: stats, trajectory and landmarks."""
    return (a.stats == b.stats and len(a.trajectory) == len(b.trajectory)
            and all((x.frame_idx, x.is_keyframe, x.n_tracked) == (y.frame_idx, y.is_keyframe, y.n_tracked)
                    and np.array_equal(x.R_cw, y.R_cw) and np.array_equal(x.t_cw, y.t_cw)
                    for x, y in zip(a.trajectory, b.trajectory))
            and np.array_equal(a.map.pt_xyz, b.map.pt_xyz))


def centre_gaps(a, b, frames) -> dict:
    """{frame: distance between the two runs' camera centres}."""
    ca = {f.frame_idx: -f.R_cw.T @ f.t_cw for f in a.trajectory}
    cb = {f.frame_idx: -f.R_cw.T @ f.t_cw for f in b.trajectory}
    return {i: float(np.linalg.norm(ca[i] - cb[i])) for i in frames}


def pipelined_phase(dev, smi, rgbd, mono, revisit) -> dict:
    """Phase 24: run_pipelined (depth 8) over phase 6's, 15's and 20's frames
    on the card, each beside its serial run of the same frames in this
    process. RGB-D twice (bit-equal) and once on the CPU (the same history,
    centres within PIPE_RGBD_ATOL); monocular beside a CPU run (the same
    frames until the second BA applies, centres within PIPE_MONO_ATOL, then
    phase 15's bars); each with 0 failures, ATE < 0.02 m for RGB-D and
    monocular; the revisit once, its ATE and closures printed (see below).
    Frames/s, host syncs per tracked frame and per init attempt, the device
    busy share and launches beside the serial run's. Arguments: (frames,
    ground truth, serial wall seconds, serial host clock after each frame)
    of each scene. Returns each run's launches."""
    from visual_slam_tpu_torch.config import SlamConfig
    from visual_slam_tpu_torch.utils.evaluate import ate_rmse

    t_start = time.perf_counter()
    out = {}
    cases = (("RGB-D", "pipelined_rgbd_60", rgbd, SlamConfig(use_depth=True)),
             ("mono", "pipelined_mono_90", mono, SlamConfig()),
             ("revisit", "pipelined_revisit_480", revisit, SlamConfig(use_depth=True)))
    for name, key, (frames, gt, serial_wall, serial_stamps), cfg in cases:
        n, t_case, stamps = len(frames), time.perf_counter(), []
        slam, wall, launches, prof = pipelined_run(frames, cfg, dev, stamps)
        out[key] = launches
        st = slam.stats
        idxs, est = slam.positions()
        mono_mode = not cfg.use_depth
        ate, _ = ate_rmse(est, gt[idxs, :3, 3], align_scale=mono_mode)
        if name == "revisit":
            want, _ = revisit_launches_wanted(slam, n)
            if launches != want:
                raise AssertionError(f"pipelined revisit: launches {launches}, expected {want}")
        else:
            check_slam_launches(f"pipelined {name}", slam, n, launches)
        kfs = [f.frame_idx for f in slam.trajectory if f.is_keyframe]
        log(f"[pipelined] {name}: {n} frames, {n / wall:.2f} frames/s ({wall:.3f} s wall), the serial "
            f"run {n / serial_wall:.2f} ({serial_wall:.3f} s); ATE {ate:.6f} m, {st['track_failures']} "
            f"track failures, keyframes at {kfs}, BAs applied {st['ba_runs']}, dropped "
            f"{st['ba_dropped_stale']}; vetoed stale {st['kf_vetoed_stale']}, re-tracked "
            f"{st['kf_retracked']}, veto cached {st['kf_veto_cached']}; launches {launches}; {smi}")
        log(f"[pipelined] {name}: wall seconds by phase {({k: round(v, 3) for k, v in prof.items()})}")
        # The revisit turns ~0.83 deg a frame. Frames dispatched against the
        # last keyframe's snapshot 8-12 frames late lose it, re-track once
        # consumed, and the chain then reseeds from a host pose as old: the
        # JAX package's run_pipelined loses this scene too (ATE 0.467 m, no
        # closure, on the CPU: tests/probe_pipelined_revisit.py). So the
        # revisit is held to the driver's own contract (every frame posed
        # once, finite, no failure, the launches), its ATE and closures
        # printed; RGB-D and monocular to ATE_LIMIT_M.
        # Monocular: the anchor and every frame from the accepted pair on.
        n_posed = n if cfg.use_depth else n - sum(0 < i < (st["init_frame"] or 0) for i, *_ in frames)
        if (st["track_failures"] != 0 or len(idxs) != n_posed or len(set(idxs.tolist())) != n_posed
                or not np.isfinite(est).all() or (name != "revisit" and not ate < ATE_LIMIT_M)):
            raise AssertionError(f"pipelined {name}: {st['track_failures']} failures, {len(idxs)} poses, "
                                 f"ATE {ate} m")
        if name == "RGB-D":
            slam2, wall2, launches2, _ = pipelined_run(frames, cfg, dev)
            if not same_run(slam, slam2) or launches2 != launches:
                raise AssertionError("pipelined RGB-D: the second card run differs from the first")
            cpu, cpu_wall, _, _ = pipelined_run(frames, cfg, "cpu")
            kf_c = [f.frame_idx for f in cpu.trajectory if f.is_keyframe]
            gaps = centre_gaps(slam, cpu, idxs.tolist())
            if (kf_c != kfs or cpu.trajectory.ba_at != slam.trajectory.ba_at
                    or cpu.stats["init_frame"] != st["init_frame"] or cpu.stats["ba_runs"] != st["ba_runs"]
                    or max(gaps.values()) > PIPE_RGBD_ATOL):
                raise AssertionError(f"pipelined RGB-D card vs CPU: keyframes {kfs} / {kf_c}, max centre "
                                     f"gap {max(gaps.values())}")
            log(f"[pipelined] RGB-D: a second card run bit-equal ({n / wall2:.2f} frames/s); the CPU run "
                f"({cpu_wall:.1f} s): the same keyframes, BA timeline and init, centres within "
                f"{max(gaps.values()):.3g} (bar {PIPE_RGBD_ATOL})")
        if name == "mono":
            cpu, cpu_wall, _, _ = pipelined_run(frames, cfg, "cpu")
            early = sorted(i for i, b in slam.trajectory.ba_at.items() if b < 2 and i in set(idxs.tolist()))
            early_c = sorted(i for i, b in cpu.trajectory.ba_at.items()
                             if b < 2 and i in {f.frame_idx for f in cpu.trajectory})
            gaps = list(centre_gaps(slam, cpu, early).values()) if early == early_c else []
            kf_c = [f.frame_idx for f in cpu.trajectory
                    if f.is_keyframe and cpu.trajectory.ba_at[f.frame_idx] < 2]
            kf_e = [i for i in kfs if slam.trajectory.ba_at[i] < 2]
            log(f"[pipelined] mono: init at {st['init_frame']} (CPU {cpu.stats['init_frame']}), re-anchors "
                f"{st['init_reanchors']}, re-verification rejects {st['init_reverify_rejects']}, rollbacks "
                f"{st['init_rollbacks']}, side-chain frames {st['init_side_chain_frames']}, orphan anchors "
                f"{st['init_orphan_frames']}; {len(early)} frames posed before the second BA applied, the "
                f"same as the CPU run's ({cpu_wall:.1f} s): {early == early_c}, centres within "
                f"{max(gaps, default=0.0):.3g} (bar {PIPE_MONO_ATOL}); {st['ransac_frames']} dispatches fell "
                f"to RANSAC (CPU {cpu.stats['ransac_frames']})")
            if (early != early_c or kf_e != kf_c or not gaps or max(gaps) > PIPE_MONO_ATOL
                    or st["init_frame"] != cpu.stats["init_frame"]):
                raise AssertionError("pipelined mono: card and CPU part before the second BA applies")
            if (st["init_frame"] != MONO_INIT_FRAME or st["keyframes"] < MIN_MONO_KEYFRAMES
                    or st["ba_runs"] < MIN_MONO_BA):
                raise AssertionError(f"pipelined mono: init {st['init_frame']}, {st['keyframes']} keyframes, "
                                     f"{st['ba_runs']} BAs")
        if name == "revisit":
            log(f"[pipelined] revisit: closures {st['loop_closures']} accepted {st['loop_accepted']}, "
                f"rejected: covisibility {st['loop_rejected_covis']}, verification {st['loop_verify_fail']}, "
                f"unsatisfied {st['loop_rejected_unsatisfied']}, warp {st['loop_rejected_warp']}")
            log(f"[pipelined] revisit: ATE {ate:.6f} m against the serial run's bar {ATE_LIMIT_M} (not held: "
                f"see above); {st['fail_retried_ok']} frames re-tracked after a lost snapshot, "
                f"{st['ransac_frames']} dispatches fell to RANSAC")
        # Where the time goes, each driver: one more run over the scene's
        # frames up to the end of its profiled window; the window's wall
        # from the host clocks of the timed runs above.
        k0, k1 = PROFILE_WINDOWS[name]
        for pipelined, clock in ((True, stamps), (False, serial_stamps)):
            c = driver_cost(frames[:k1], cfg, dev, pipelined, k0)
            w = clock[k1 - 1] - clock[k0 - 1]
            per_init = "none" if c["syncs_per_init"] is None else f"{c['syncs_per_init']:.2f}"
            log(f"[pipelined] {name} {'pipelined' if pipelined else 'serial'}: frames {k0}-{k1 - 1} of the "
                f"stream {(k1 - k0) / w:.2f} frames/s, device {c['device_ms']:.1f} ms of {1e3 * w:.1f} ms "
                f"wall: busy share {c['device_ms'] / (1e3 * w):.3f}; over its first {k1} frames host syncs "
                f"(sync-debug) {c['syncs']}: {c['syncs_per_tracked']:.2f} per tracked frame, {per_init} "
                f"per init attempt ({c['init_attempts']} frames before the map; trace read in "
                f"{c['read_s']:.2f} s); {smi}")
        log(f"[pipelined] {name}: {time.perf_counter() - t_case:.1f} s")
    log(f"[pipelined] phase 24 took {time.perf_counter() - t_start:.1f} s")
    return out


# Phase 25: the entry module (visual_slam_tpu_torch/entry.py). The step's
# card run against its CPU run, the same minimal sets injected, n_in equal:
# on a snapshot of the frame's own features (the GN branch) R, t 1e-4
# (tests/test_torch_entry.py's step bar); on entry()'s own, which matches
# nothing, within twice entry.dlt_null_vector_bound (R; t that times |t|),
# how far float32 eigensolvers may part on the one DLT. The dry run's five
# solves on the card against the same call on the CPU at that file's bars:
# the chain pose graph t 1e-4, R 1e-5; Sim3 R, t, log-scales 1e-4; the
# front-end's uv and valid equal, score rtol 1e-5, >= 99.5% of descriptor
# bits. Its bundle adjustments are degenerate (four cameras within 2 cm of
# the origin: no baseline, the scale free), so each is held bit for bit to
# the unsharded solve on its device, to the CPU within ENTRY_SPREAD_FACTOR x
# the CPU solve's own spread: the farthest it moves when its translations
# are scaled by 1 + k PERTURB, k = +-1 .. +-DRY_PERTURB_STEPS (the cost of
# the large-map solve, ~81, moves by up to 15 over those eight on the CPU,
# by 2 over k = +-1 alone); and to a cost below its start.
ENTRY_STEPS, ENTRY_POSE_ATOL = 20, 1e-4
DRY_PERTURB_STEPS = 4
DRY_CHAIN_T_ATOL, DRY_CHAIN_R_ATOL, DRY_SIM3_ATOL = 1e-4, 1e-5, 1e-4
ENTRY_SPREAD_FACTOR = 2.0
ROOF_K, ROOF_M = 1024, 2048  # one tracked frame of the SLAM loop (SlamConfig defaults)


def dry_solve(kind, device, scale=1.0) -> dict:
    """The dry run's solve `kind` ("ba", "large") unsharded on `device`, its
    translations scaled by `scale`: R, t, X and cost as NumPy."""
    from visual_slam_tpu_torch import entry
    from visual_slam_tpu_torch.models import ba, ba_large

    p, _ = ba.make_problem(**entry.dryrun_problems(1)["ba"], device=device)
    fn = ba.optimize if kind == "ba" else ba_large.optimize
    out, cost = fn(p._replace(t=p.t * scale), n_iters=entry.DRY_ITERS, cg_iters=entry.DRY_CG)
    return {k: v.cpu().numpy() for k, v in dict(R=out.R, t=out.t, X=out.X, cost=cost).items()}


def entry_phase(dev, smi, gray_np) -> dict:
    """Phase 25: entry()'s step on the card against the CPU, on entry()'s
    snapshot and on one of the frame's own features, its median ms over
    ENTRY_STEPS steps of each and its B1/B3 launches; the stage table of one
    tracked frame; dryrun_multichip(1) on an NCCL world of one rank here
    against the same call on the CPU (gloo). Returns launches by path."""
    from visual_slam_tpu_torch import entry
    from visual_slam_tpu_torch.models import ba, frontend
    from visual_slam_tpu_torch.ops import match, ransac
    from visual_slam_tpu_torch.utils import roofline

    t_start = time.perf_counter()
    step, gargs = entry.entry(dev)
    _, cargs = entry.entry("cpu")
    f = frontend.extract(cargs[0], entry.STEP_FEATURES)  # the CPU step's features
    snap = entry.matched_snapshot(f, cargs[6])
    cases = {"step": (cargs, gargs),  # entry()'s own arguments
             "step_matched": ((cargs[0], *snap, *cargs[4:]),
                              (gargs[0], *(a.to(dev) for a in snap), *gargs[4:]))}
    paths = {}
    for name, (ca, ga) in cases.items():
        # The same minimal sets on both sides, drawn on the CPU over the CPU
        # step's matches.
        idx2, _, good = match.match_ratio_test(ca[1], f.desc, ca[3], f.valid)
        idx = ransac.sample_minimal_sets(torch.Generator().manual_seed(0), entry.STEP_HYPS, 6, good)
        want = step(*ca, idx=idx)
        idx_dev = idx.to(dev)
        step(*ga, idx=idx_dev)  # warm-up
        torch.cuda.synchronize()
        zero_kernel_counts()
        ms = []
        for _ in range(ENTRY_STEPS):
            t0 = time.perf_counter()
            got = step(*ga, idx=idx_dev)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        launches = kernel_counts()
        paths[f"entry_{name}_{ENTRY_STEPS}"] = launches
        dR = float((got[0].cpu() - want[0]).abs().max())
        dt = float((got[1].cpu() - want[1]).abs().max())
        bar_R = bar_t = ENTRY_POSE_ATOL
        how = f"the GN branch, bar {ENTRY_POSE_ATOL}"
        if name == "step":
            # No match: the pose is the DLT of one minimal set, its float32
            # null vector conditioned at kappa (entry.dlt_null_vector_bound).
            intr = ca[6].double()
            xn = ((f.uv[idx2][idx[0]].double() - intr[2:]) / intr[:2]).numpy()
            kappa = entry.dlt_null_vector_bound(ca[2][idx[0]].numpy(), xn)
            bar_R, bar_t = 2 * kappa, 2 * kappa * float(want[1].norm())
            how = f"RANSAC's DLT, kappa {kappa:.3g}: bars R {bar_R:.3g}, t {bar_t:.3g}"
        log(f"[entry] {name} ({entry.STEP_FEATURES} features, {int(good.sum())} matches, "
            f"{how}): median {statistics.median(ms):.3f} ms a step over {ENTRY_STEPS} (min "
            f"{min(ms):.3f}, max {max(ms):.3f}); card vs CPU R {dR:.3g}, t {dt:.3g}, n_in "
            f"{int(got[2])} / {int(want[2])}; launches {launches}; {smi}")
        if dR > bar_R or dt > bar_t or int(got[2]) != int(want[2]):
            raise AssertionError(f"entry {name}: card vs CPU R {dR}, t {dt}, n_in {int(got[2])} "
                                 f"vs {int(want[2])}")
        if launches["detect_blur"] != ENTRY_STEPS or launches["patch"] != ENTRY_STEPS:
            raise AssertionError(f"entry {name}: {launches} over {ENTRY_STEPS} steps, not B1 "
                                 f"and B3 once a step")

    # The stage table of one tracked frame, queued CUDA events a stage
    # (a stage of more launches than the launch queue holds, PnP's two GN
    # loops, is timed at the host's launch rate; the profiler's sum of its
    # kernels is printed beside each stage)
    stages = roofline.tracking_stages(dev, gray_np, ROOF_K, ROOF_M)
    stage_ms = {name: queued_ms(fn) for name, fn in stages.items()}
    kernel_ms = {name: device_ms(fn, iters=10) for name, fn in stages.items()}
    H, W = gray_np.shape
    table = roofline.stage_table(roofline.stage_costs(H=H, W=W, K=ROOF_K, M=ROOF_M), stage_ms)
    log(f"[entry] stage table, {W}x{H}, K={ROOF_K}, M={ROOF_M} (queued CUDA events; "
        f"roofline.stage_costs over the H100's peaks); {smi}")
    for name, row in table.items():
        log(f"[entry]   {name:12s} {row['ms']:.4f} ms  {row['gflops']:.4f} GFLOP ({row['dtype']})  "
            f"{row['mbytes']:.2f} MB  {row.get('achieved_tflops')} TFLOP/s "
            f"({row.get('pct_compute_peak')}%)  {row.get('achieved_gbps')} GB/s "
            f"({row.get('pct_hbm_peak')}%)  {row['bound']}; kernels {kernel_ms[name][0]:.4f} ms "
            f"({kernel_ms[name][1]})")
    log(f"[entry]   pnp_ransac_branch {stage_ms['pnp_ransac_branch']:.4f} ms (the tracked solver from a "
        f"prior 40/40 deg off; no stage_costs row); kernels {kernel_ms['pnp_ransac_branch'][0]:.4f} ms")
    log(f"[entry] stage table JSON {json.dumps(table)}")

    # dryrun_multichip(1): an NCCL world of one rank here, then the CPU
    torch.cuda.synchronize()
    zero_kernel_counts()
    t0 = time.perf_counter()
    card, = entry.dryrun_multichip(1, device=dev)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    dry_launches = kernel_counts()
    cpu, = entry.dryrun_multichip(1, device="cpu")
    gaps = {}
    start = float(ba._cost(ba.make_problem(**entry.dryrun_problems(1)["ba"], device="cpu")[0]))
    for kind in ("ba", "large"):
        # A world of one rank is the unsharded solve, bit for bit, on both
        base = {d: dry_solve(kind, d) for d in (dev, "cpu")}
        moved = [dry_solve(kind, "cpu", 1 + s * k * PERTURB) for k in range(1, DRY_PERTURB_STEPS + 1)
                 for s in (1, -1)]
        for k in ("R", "t", "X", "cost"):
            spread = max(float(np.abs(m[k] - base["cpu"][k]).max()) for m in moved)
            gaps[f"{kind}_{k}"] = (float(np.abs(card[f"{kind}_{k}"] - cpu[f"{kind}_{k}"]).max()),
                                   ENTRY_SPREAD_FACTOR * spread)
            if not (np.array_equal(card[f"{kind}_{k}"], base[dev][k])
                    and np.array_equal(cpu[f"{kind}_{k}"], base["cpu"][k])):
                raise AssertionError(f"dry run {kind}: a world of one is not the unsharded solve ({k})")
        if not float(card[f"{kind}_cost"]) < start:
            raise AssertionError(f"dry run {kind}: card cost {float(card[f'{kind}_cost'])} from {start}")
    for k, bar in (("pg_t", DRY_CHAIN_T_ATOL), ("pg_R", DRY_CHAIN_R_ATOL), ("sim3_R", DRY_SIM3_ATOL),
                   ("sim3_t", DRY_SIM3_ATOL), ("sim3_lam", DRY_SIM3_ATOL)):
        gaps[k] = (float(np.abs(card[k] - cpu[k]).max()), bar)
    v = cpu["fe_valid"]
    bits = (desc_bits(torch.from_numpy(card["fe_desc"][v])) == desc_bits(torch.from_numpy(cpu["fe_desc"][v]))).mean()
    score = float(np.abs(card["fe_score"][v] / cpu["fe_score"][v] - 1).max())
    log(f"[entry] dryrun_multichip(1) on an NCCL world of one: {dry_s:.2f} s; launches {dry_launches}; "
        f"card vs CPU (gap, bar): {({k: (f'{g:.3g}', f'{b:.3g}') for k, (g, b) in gaps.items()})}; "
        f"front-end uv/valid equal {np.array_equal(card['fe_uv'], cpu['fe_uv']) and np.array_equal(card['fe_valid'], v)}, "
        f"score rtol {score:.3g}, descriptor bits {bits:.4f}; {smi}")
    bad = {k: g for k, g in gaps.items() if not g[0] <= g[1]}
    if bad or not (np.array_equal(card["fe_uv"], cpu["fe_uv"]) and np.array_equal(card["fe_valid"], v)) \
            or score > PEAK_RTOL or bits < MIN_DESC_BIT_AGREEMENT:
        raise AssertionError(f"dry run: card vs CPU over the bars {bad}, score {score}, bits {bits}")
    if min(dry_launches.values()) == 0:
        raise AssertionError(f"dry run: a kernel never launched ({dry_launches})")
    log(f"[entry] phase 25 took {time.perf_counter() - t_start:.1f} s")
    return {**paths, "dryrun_multichip_1": dry_launches}


# Phase 26: the benchmark (visual_slam_tpu_torch/bench.py) as a subprocess at
# a short size: 80 frames, so the monocular init (near frame ~36 at stride 1)
# lands well inside the run; its contract and its verdict checked here.
BENCH_ARGS = ("--frames", "80", "--fullseq-frames", "0", "--sections", "headline,device_rate,roofline")
BENCH_TIMEOUT_S = 420
BENCH_SUMMARY_KEYS = ("metric", "value", "unit", "fps_io_passes", "fps_no_io", "fps_device_rate",
                      "ate_rmse_m", "tracking_phase_fps", "init_phase_s", "mode", "keyframes",
                      "correct", "device")


def bench_phase(dev, smi) -> dict:
    """Phase 26: `python -m visual_slam_tpu_torch.bench` on the card at
    BENCH_ARGS: exit 0, the full record on the line before the last and the
    compact headline on the last, both naming this card, "correct" true,
    B1 and B3 once a frame of each headline run. Returns the launches of the
    headline's io run, counted in the bench's own process."""
    t_start = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "visual_slam_tpu_torch.bench", *BENCH_ARGS],
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or len(lines) < 2:
        raise AssertionError(f"bench: exit {res.returncode}, {len(lines)} stdout lines; stderr tail "
                             f"{res.stderr[-3000:]}")
    rec, head = json.loads(lines[-2]), json.loads(lines[-1])
    missing = [k for k in BENCH_SUMMARY_KEYS if k not in head]
    kind = torch.cuda.get_device_name(0)
    if missing or head.get("partial") or not (rec["correct"] is True and head["correct"] is True):
        raise AssertionError(f"bench: summary keys missing {missing}, correct {rec['correct']}, "
                             f"checks {rec['checks']}")
    if rec["device"]["kind"] != kind or head["device"]["kind"] != kind or rec["device"]["smi"] != smi:
        raise AssertionError(f"bench: device {rec['device']}, not {kind} ({smi})")
    h = rec["sections"]["headline"]
    for run in (h["io"], h["no_io"], h["other_driver"]):
        n = run["frames"]
        if run["launches"]["detect_blur"] != n or run["launches"]["patch"] != n:
            raise AssertionError(f"bench: {run['driver']} headline run launched {run['launches']} over {n} frames")
    dr, roof = rec["sections"]["device_rate"], rec["sections"]["roofline"]
    log(f"[bench] {' '.join(BENCH_ARGS)}: headline {head['value']:.2f} frames/s with decode (passes "
        f"{[round(f, 2) for f in head['fps_io_passes']]}), {head['fps_no_io']:.2f} without, "
        f"{h['driver']}; {h['other_driver']['driver']} {h['other_driver']['fps']:.2f}; Sim3 ATE "
        f"{head['ate_rmse_m']:.6f} m, init frame {h['io']['history']['init']}, init phase "
        f"{head['init_phase_s']:.2f} s, tracking phase {head['tracking_phase_fps']:.2f} frames/s, "
        f"keyframes at {h['io']['history']['keyframes']}; {smi}")
    log(f"[bench] device rate {dr['fps_device_rate_per_dispatch']:.2f} frames/s by the host clock, "
        f"{dr['fps_device_rate']:.2f} by device-busy time (busy share {dr['busy_share']:.3f}), "
        f"{dr['host_syncs_per_frame']:.2f} host syncs a frame, {dr['ransac_frames']} of {dr['frames']} "
        f"frames took RANSAC; roofline ms {({k: round(v['ms'], 4) for k, v in roof['table'].items()})}, "
        f"RANSAC branch {roof['pnp_ransac_branch_ms']:.3f} ms; checks {rec['checks']}")
    log(f"[bench] phase 26 took {time.perf_counter() - t_start:.1f} s (the bench's own sections "
        f"{({k: round(v['section_s'], 1) for k, v in rec['sections'].items()})})")
    return {"bench_headline_80": h["io"]["launches"]}


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
    from visual_slam_tpu_torch.models import ba, frontend
    from visual_slam_tpu_torch.ops.kernels import build, detect_kernel, patch_kernel, seg_kernel
    from visual_slam_tpu_torch.pipeline import Slam, ba_step, run_sequence, track_step
    from visual_slam_tpu_torch.utils.evaluate import ate_rmse
    from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene
    from visual_slam_tpu_torch import native

    # The native PNG loader is host IO, off the card's path: information only.
    t0 = time.perf_counter()
    native_ok = native.available()
    log(f"[device] native PNG loader {'available' if native_ok else 'unavailable'} after "
        f"{time.perf_counter() - t0:.2f} s" + ("" if native_ok else f": {native.build_error}"))

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    log(f"[build] {lib_path.name} ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})")

    # 3. B1 (and B2 mode) vs plain, on the card: bit for bit, -inf included,
    #    at 480x640 and at ragged sizes, with the 16 px border frame and none
    b1_err = 0.0
    images = [("noise 480x640", smooth_noise(480, 640, 0)), ("checker 480x640", checkerboard())]
    images += [(f"raw {h}x{w}", uniform_noise(h, w, h + w)) for h, w in RAGGED_SIZES]
    for name, img_np in images:
        img = torch.from_numpy(img_np).to(dev)
        for border in (16, 0):
            pk, bk = detect_kernel.corner_peaks_and_blur(img, border=border)
            pp, bp = detect_kernel.corner_peaks_and_blur_torch(img, border=border)
            p2 = detect_kernel.corner_peaks(img, border=border)
            torch.cuda.synchronize()
            fin = torch.isfinite(pp)
            if not (torch.equal(pk, pp) and torch.equal(bk, bp) and torch.equal(p2, pp)):
                raise AssertionError(
                    f"B1 {name} border {border}: not bit-equal to the plain version (peaks "
                    f"{torch.equal(pk, pp)}, blur {torch.equal(bk, bp)}, B2 mode {torch.equal(p2, pp)})")
            if min(img.shape) <= 2 * border and fin.any():
                raise AssertionError(f"B1 {name} border {border}: finite peaks inside the border frame")
            perr = (pk[fin] - pp[fin]).abs().max().item() if fin.any() else 0.0
            berr = (bk - bp).abs().max().item()
            b1_err = max(b1_err, perr, berr)
            log(f"[B1] {name} border {border}: {int(fin.sum())} finite peaks; peaks, blur and the "
                f"B2 mode bit-equal to the plain version")

    # B1 on stacks: one launch over B images, bit-equal to the plain version
    # on the stack and to B single launches; the stacks' ragged sizes put
    # tile edges inside every image.
    for B, (h, w) in BATCH_CASES:
        stack = torch.from_numpy(np.stack([uniform_noise(h, w, h + w + b) for b in range(B)])).to(dev)
        for border in (16, 0):
            pk, bk = detect_kernel.corner_peaks_and_blur(stack, border=border)
            pp, bp = detect_kernel.corner_peaks_and_blur_torch(stack, border=border)
            p2 = detect_kernel.corner_peaks(stack, border=border)
            singles = [detect_kernel.corner_peaks_and_blur(stack[b], border=border) for b in range(B)]
            torch.cuda.synchronize()
            if not (torch.equal(pk, pp) and torch.equal(bk, bp) and torch.equal(p2, pp)
                    and all(torch.equal(pk[b], p) and torch.equal(bk[b], q) for b, (p, q) in enumerate(singles))):
                raise AssertionError(f"B1 stack of {B} at {h}x{w} border {border}: not bit-equal to the plain "
                                     f"version and to {B} single launches")
        log(f"[B1] stack of {B} at {h}x{w}, border 16 and 0: one launch, peaks, blur and the B2 mode "
            f"bit-equal to the plain version and to {B} single launches")

    # B1's branch-free square root against CUDA's IEEE one, every float
    bad, first = detect_kernel.sqrt_check(dev)
    if bad:
        raise AssertionError(f"B1's square root differs from __fsqrt_rn on {bad} floats (first {first:#x})")
    log("[B1] square root equal to __fsqrt_rn on every float from +0 to +inf")

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
    for B, (h, w) in BATCH_CASES:
        stack = torch.from_numpy(np.stack([uniform_noise(h, w, h + w + b) for b in range(B)])).to(dev)
        uvs = torch.from_numpy(np.stack([edge_keypoints(h, w, 1024, seed=b) for b in range(B)])).to(dev)
        pk = patch_kernel.extract_patches(stack, uvs)
        pp = patch_kernel.extract_patches_torch(stack, uvs)
        singles = [patch_kernel.extract_patches(stack[b], uvs[b]) for b in range(B)]
        torch.cuda.synchronize()
        if not (torch.equal(pk, pp) and all(torch.equal(pk[b], q) for b, q in enumerate(singles))):
            raise AssertionError(f"B3 stack of {B} at {h}x{w}: not bit-equal to the plain version and "
                                 f"to {B} single launches")
        log(f"[B3] stack of {B} at {h}x{w}, K=1024: one launch bit-equal to the plain version and to "
            f"{B} single launches")

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
    # The batched front-end: one B1 and one B3 launch for 4 frames, each
    # frame's features bit-equal to its own extract on the card.
    stack = torch.from_numpy(np.stack([rendered[i][1] for i in (0, 20, 40, 59)])).to(dev)
    n1, n3 = detect_kernel.launches, patch_kernel.launches
    fb = frontend.extract_batch(stack, 1024)
    torch.cuda.synchronize()
    if (detect_kernel.launches - n1, patch_kernel.launches - n3) != (1, 1):
        raise AssertionError("extract_batch: not one B1 and one B3 launch for the stack")
    for b in range(4):
        f1 = frontend.extract(stack[b], 1024)
        if not all(torch.equal(getattr(fb, k)[b], getattr(f1, k)) for k in f1._fields):
            raise AssertionError(f"extract_batch: frame {b} differs from its single extract")
    log("[frontend] extract_batch over 4 frames: one B1 and one B3 launch, each frame's uv, desc, "
        "score and valid bit-equal to its single extract")

    # 6. the RGB-D SLAM loop at full width on the card
    cfg = SlamConfig(use_depth=True)
    run_sequence(FrameList(rendered[:26]), SlamConfig(use_depth=True), device=dev)  # warm-up, one BA
    rgbd_stamps = []
    slam, wall, launches = run_slam(rendered, cfg, dev, rgbd_stamps)
    idxs, est = slam.positions()
    if len(idxs) != FRAMES or not np.isfinite(est).all():
        raise AssertionError(f"RGB-D: {len(idxs)} poses, finite {np.isfinite(est).all()}")
    ate, _ = ate_rmse(est, scene.ground_truth()[idxs, :3, 3], align_scale=False)
    n_ba = check_slam_launches("RGB-D", slam, FRAMES, launches)
    slam_report("RGB-D", slam, FRAMES, wall, launches, n_ba, ate, smi)
    if ate >= ATE_LIMIT_M:
        raise AssertionError(f"RGB-D: ATE {ate} m >= {ATE_LIMIT_M}")
    if slam.stats["track_failures"] != 0:
        raise AssertionError(f"RGB-D: {slam.stats['track_failures']} track failures")
    if slam.stats["keyframes"] < 2 or slam.stats["ba_runs"] < 1:
        raise AssertionError(f"RGB-D: {slam.stats['keyframes']} keyframes inserted, "
                             f"{slam.stats['ba_runs']} BAs applied")
    # Where a keyframe BA's time goes: one BA step on the run's final map,
    # host time per call beside device time per call.
    prob, _ = slam.map.to_ba_problem(cfg.intrinsics, depth_weight=cfg.ba.depth_weight, device=dev)
    solve = lambda: ba_step(prob, cfg.ba.iters, cfg.ba.cg_iters, cfg.ba.solver, use_depth=True)
    ba_wall = cuda_ms(solve, iters=5, warmup=1)
    ba_dev, how = device_ms(solve, iters=5)
    log(f"[RGB-D BA] one BA step on the final map (K={prob.R.shape[0]}, P={prob.X.shape[0]}, "
        f"N={prob.cam.shape[0]}, {cfg.ba.iters} LM x {cfg.ba.cg_iters} CG): {ba_wall:.3f} ms per "
        f"call, {ba_dev:.3f} ms device ({how}): device busy share {ba_dev / ba_wall:.3f}, "
        f"{count_syncs(solve)} host syncs per call (torch's sync-debug mode); {smi}")
    # The profiler's own window start may add a call: an empty window and
    # one .item() are read beside the BA step.
    empty, item = runtime_syncs(lambda: None), runtime_syncs(lambda: torch.ones(1, device=dev).sum().item())
    log(f"[RGB-D BA] host-blocking runtime calls ({', '.join(SYNC_CALLS)}), profiler trace: "
        f"one BA step {runtime_syncs(solve)}, an empty window {empty}, one .item() {item}")
    # B4/B5 against their plain versions at the shapes that BA step gives
    # them: the (42,N) U/g_c reduce over the final map's camera index and
    # the (12,K) camera-table expand; timed in turns. That index puts
    # thousands of slots on a few cameras (padding slots on camera 0), where
    # index_add_'s own float32 sums drift past the bar, so B4 is held to
    # index_add_ on dyadic rows (multiples of 1/256, as phase 10's hot
    # cameras), whose sums are exact: bit-equal. On normal rows it must give
    # the same bits on ten calls and come no farther from the float64 sums
    # than index_add_.
    K6, N6 = prob.R.shape[0], prob.cam.shape[0]
    rng6 = np.random.default_rng(6)
    rows = torch.from_numpy((rng6.integers(-1024, 1024, (42, N6)) / 256).astype(np.float32)).to(dev)
    normal = torch.from_numpy(rng6.normal(size=(42, N6)).astype(np.float32)).to(dev)
    hot = int(torch.bincount(prob.cam.long().clamp(0, K6)).max())
    table = ba.cam_rows(prob)
    plan6 = seg_kernel.reduce_plan(prob.cam, K6)
    kerr6, lerr6 = check_reduce_repeats(f"B4 (42,{N6})->(42,{K6}) on the BA path", normal, prob.cam,
                                        K6, plan6, hot=hot >= 1000)
    path_fns = {
        "B4": (lambda: seg_kernel.cam_reduce(rows, prob.cam, K6, plan6),
               lambda: seg_kernel.cam_reduce_torch(rows, prob.cam, K6),
               library_reduce(rows, prob.cam, K6)),
        "B5": (lambda: seg_kernel.cam_expand(table, prob.cam),
               lambda: seg_kernel.cam_expand_torch(table, prob.cam),
               library_expand(table, prob.cam)),
    }
    rk, rp = (f() for f in path_fns["B4"][:2])
    ek, ep = (f() for f in path_fns["B5"][:2])
    torch.cuda.synchronize()
    if not torch.equal(rk, rp):
        raise AssertionError(f"B4 (42,{N6})->(42,{K6}) on the BA path: exact (dyadic) sums differ "
                             f"from the plain version by {(rk - rp).abs().max().item()}")
    if not torch.equal(ek, ep):
        raise AssertionError(f"B5 (12,{K6})->(12,{N6}) on the BA path: not bit-equal to the plain version")
    path_err = {"cam_reduce": (rk - rp).abs().max().item(), "cam_expand": (ek - ep).abs().max().item()}
    path_times = {}
    for name, (kernel_fn, plain_fn, library_fn) in path_fns.items():
        p1, k1, k2, p2 = (queued_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
        path_times[name] = (min(k1, k2), min(p1, p2), queued_ms(library_fn))
    plan6_ms = cuda_ms(lambda: seg_kernel.reduce_plan(prob.cam, K6), iters=20, warmup=3)
    path_bounds = {"B4": bound_ms(4 * (42 * N6 + N6 + 42 * K6), 42 * N6),
                   "B5": bound_ms(4 * (12 * K6 + N6 + 12 * N6), 0)}
    log(f"[RGB-D BA] B4 (42,{N6})->(42,{K6}), up to {hot} slots on one camera: bit-equal to plain "
        f"on dyadic rows; on normal rows the same bits on 10 calls, {kerr6:.3g} from the float64 "
        f"sums (index_add_ {lerr6:.3g}); kernel {path_times['B4'][0]:.4f} ms vs plain "
        f"{path_times['B4'][1]:.4f} ms vs index_add_ {path_times['B4'][2]:.4f} ms, bound {path_bounds['B4'][0]:.5f} ms "
        f"({path_bounds['B4'][1]}); plan ({plan6.tile}-slot tiles, {int(plan6.tile_ptr[-1])} of at "
        f"most {plan6.max_runs} runs): built in {plan6_ms:.4f} ms, {plan6.nbytes() / 1e6:.4f} MB, "
        f"+ {42 * plan6.max_runs * 4 / 1e6:.4f} MB of partials per call; {smi}")
    # The launch floor beside B5: one launch of a one-element zero_(), timed the same way.
    z = torch.zeros(1, device=dev)
    floor_ms = queued_ms(lambda: z.zero_())
    g6 = seg_kernel.expand_geometry(12, N6, *seg_kernel._card(0), prob.cam.data_ptr() % 16 == 0)
    log(f"[RGB-D BA] B5 (12,{K6})->(12,{N6}): bit-equal, kernel {path_times['B5'][0]:.4f} ms vs "
        f"plain {path_times['B5'][1]:.4f} ms vs index_select {path_times['B5'][2]:.4f} ms, bound "
        f"{path_bounds['B5'][0]:.5f} ms, launch floor (one-element zero_()) {floor_ms:.4f} ms "
        f"(queued events); {g6.chunks} chunks of {g6.ck} channels, "
        f"{g6.grid_x * g6.chunks} blocks of {g6.threads}; {smi}")
    del rows, normal, table, rk, rp, ek, ep

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
        queued = ""
        if name in ("B1", "B2"):
            p1, k1, k2, p2 = (queued_ms(f) for f in (plain_fn, kernel_fn, kernel_fn, plain_fn))
            queued = f"; queued events: kernel {min(k1, k2):.4f} ms, plain {min(p1, p2):.4f} ms"
        log(f"[timing] {name}: kernel {times[name][0]:.4f} ms device / {kc:.4f} ms per call; "
            f"plain {times[name][1]:.4f} ms device / {pc:.4f} ms per call "
            f"(device time by {'+'.join(methods)}{queued}; {smi})")
    # A floor for B1's bytes, not a library call: one PyTorch copy that reads
    # the frame once and writes two frames' worth.
    floor_fn = lambda: gray.repeat(2, 1)  # noqa: E731
    floor_dev, how = device_ms(floor_fn)
    floor_queued = queued_ms(floor_fn)
    log(f"[timing] B1 copy floor (gray.repeat(2, 1): reads {gray.numel() * 4 / 1e6:.2f} MB, writes "
        f"{2 * gray.numel() * 4 / 1e6:.2f} MB): {floor_dev:.4f} ms device ({how}), {floor_queued:.4f} ms "
        f"queued events; B1 takes {times['B1'][0] / floor_dev:.3f}x the floor; {smi}")
    # B3's library call: one advanced-indexing gather (B1 and B2 have none).
    library_fn = library_patch(blurred, uv_path)
    if not torch.equal(library_fn(), patch_kernel.extract_patches(blurred, uv_path)):
        raise AssertionError("B3: the library gather differs from the kernel")
    b3_library_ms, how = device_ms(library_fn)
    log(f"[timing] B3: library (img[rows, cols]) {b3_library_ms:.4f} ms device ({how}); {smi}")
    # Bounds: B1 reads the frame and writes peaks and blur, about 100 float
    # operations a pixel (Sobel 22, products and 3x3 box 18, eigenvalue 8,
    # 7x7 max 13, blur 36); B2 the same without the blur (64 a pixel, one
    # output); B3 reads the frame and uv and writes K 32x32 patches, copies
    # only.
    H, W = gray.shape
    K3 = uv_path.shape[0]
    bounds = {"B1": bound_ms(4 * 3 * H * W, 100 * H * W),
              "B2": bound_ms(4 * 2 * H * W, 64 * H * W),
              "B3": bound_ms(4 * (H * W + 2 * K3 + 32 * 32 * K3), 0)}
    for name, (b, by) in bounds.items():
        log(f"[timing] {name}: bound {b:.5f} ms ({by}); kernel at {b / times[name][0]:.3f} of it")
    # B1 and B3 on stacks of B frames (config #3's one launch a step)
    # beside B single launches, in turns (stack, singles, singles, stack):
    # device time by queued events, which count the gaps between launches
    # that the stack saves and cannot drop a launch (a profiler window read
    # B3 at B=4 as 0.0001 ms on an H100), and by the profiler beside it; the
    # bound is B times one frame's.
    batch_times = {}
    for B in (1, 4, 8):
        stack = torch.from_numpy(np.stack([rendered[i][1] for i in range(B)])).to(dev)
        _, blur_stack = detect_kernel.corner_peaks_and_blur(stack)
        uv_stack = frontend.extract_batch(stack, 1024).uv
        pairs = {
            "B1": (lambda: detect_kernel.corner_peaks_and_blur(stack),
                   lambda: [detect_kernel.corner_peaks_and_blur(stack[b]) for b in range(B)]),
            "B3": (lambda: patch_kernel.extract_patches(blur_stack, uv_stack),
                   lambda: [patch_kernel.extract_patches(blur_stack[b], uv_stack[b]) for b in range(B)]),
        }
        for name, (one, singles) in pairs.items():
            d = [device_ms(f)[0] for f in (one, singles, singles, one)]
            q = [queued_ms(f) for f in (one, singles, singles, one)]
            b, by = bounds[name]
            row = dict(B=B, ms=min(q[0], q[3]), singles_ms=min(q[1], q[2]), profiler_ms=min(d[0], d[3]),
                       singles_profiler_ms=min(d[1], d[2]), bound_ms=B * b, bound_by=by)
            batch_times.setdefault(name, []).append(row)
            log(f"[timing] {name} stack of {B} at {H}x{W}, K={K3}: one launch {row['ms']:.4f} ms "
                f"({row['ms'] / B:.4f} ms an image), {B} single launches {row['singles_ms']:.4f} ms (queued "
                f"events); profiler {row['profiler_ms']:.4f} vs {row['singles_profiler_ms']:.4f} ms; bound "
                f"{row['bound_ms']:.5f} ms ({by}), the launch at {row['bound_ms'] / row['ms']:.3f} of it; {smi}")

    # 9. where a tracked frame's time goes: device kernels by name
    pslam = Slam(cfg, device=dev)
    pslam.process(*rendered[0])
    n_prof = 10
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for frame in rendered[1:1 + n_prof]:
            pslam.process(*frame)
        torch.cuda.synchronize()
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages() if device_us(e) > 0]
    dev_ms = sum(r[1] for r in rows) / 1e3 / n_prof
    frame_syncs = count_syncs(lambda: pslam.process(*rendered[1 + n_prof]))
    wall_ms = statistics.median(slam.timers.ms["extract"]) + statistics.median(slam.timers.ms["track"])
    log(f"[profile] {n_prof} tracked frames: {dev_ms:.3f} ms/frame of device time, "
        f"{sum(r[2] for r in rows) / n_prof:.0f} device ops/frame; against the median extract + "
        f"track {wall_ms:.3f} ms/frame of phase 6: device busy share {dev_ms / wall_ms:.3f}; "
        f"{frame_syncs} host syncs in the next tracked frame")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"[profile]   {us / 1e3 / n_prof:8.4f} ms/frame {count / n_prof:6.1f}/frame  {key[:90]}")

    seg_times = seg_phases(dev, smi)
    mono_launches, mono_run = mono_phases(dev, smi)
    lap = [time.perf_counter()]
    for phase in (pg_phase, score_phase, close_loop_phase):
        phase(dev, smi)
        lap.append(time.perf_counter())
    frames = render_revisit(REVISIT_FRAMES)
    lap.append(time.perf_counter())
    revisit_launches, revisit_wall, revisit_stamps = revisit_phase(dev, smi, frames)
    lap.append(time.perf_counter())
    batched_launches = batched_phase(dev, smi, frames)
    lap.append(time.perf_counter())
    sharded_launches, sharded_times = sharded_phase(dev, smi)
    cli_launches = cli_phase(dev, smi, rendered, scene.ground_truth())
    revisit_gt = SyntheticRGBDScene(REVISIT_FRAMES, trajectory="revisit").ground_truth()
    pipelined_launches = pipelined_phase(dev, smi, (rendered, scene.ground_truth(), wall, rgbd_stamps),
                                         mono_run, (frames, revisit_gt, revisit_wall, revisit_stamps))
    entry_launches = entry_phase(dev, smi, rendered[0][1])
    bench_launches = bench_phase(dev, smi)
    secs = np.diff(lap)
    log(f"[loop] phases 17-21 took {lap[-1] - lap[0]:.1f} s: pose graph {secs[0]:.1f}, scoring "
        f"{secs[1]:.1f}, close loop {secs[2]:.1f}, rendering {REVISIT_FRAMES} frames in {RENDER_THREADS} "
        f"threads {secs[3]:.1f}, two revisit runs {secs[4]:.1f}, config #3 {secs[5]:.1f}; revisit "
        f"launches {revisit_launches}")
    # Each path's launches, its counts set to 0 just before it: phase 6
    # (`launches` below), 15 (twice), 20 (one of its two runs), 21, 22 (its
    # sharded solves; a fleet path sums its ranks' counts), 23 (the
    # command line's own process, counted there around its run), 24 (the
    # pipelined driver, one run of each scene), 25 (the entry step's 20
    # steps on each of its two snapshots, the dry run on a world of one) and
    # 26 (the bench's headline io run, counted in its own process).
    by_path = {"rgbd_60": launches, **mono_launches, "revisit_480": revisit_launches,
               "batched_4x60": batched_launches, **sharded_launches, "cli_rgbd_60": cli_launches,
               **pipelined_launches, **entry_launches, **bench_launches}

    kernels = [
        dict(name="detect_blur", route="cuda", source="visual_slam_tpu_torch/csrc/detect_blur.cu",
             replaces="visual_slam_tpu/ops/pallas/detect_kernel.py:123",
             launches=launches["detect_blur"], max_abs_err=b1_err,
             ms=times["B1"][0], plain_ms=times["B1"][1], bound_ms=bounds["B1"][0],
             bound_by=bounds["B1"][1], library_ms=None, batched=batch_times["B1"]),
        dict(name="patch", route="cuda", source="visual_slam_tpu_torch/csrc/patch.cu",
             replaces="visual_slam_tpu/ops/pallas/patch_kernel.py:32",
             launches=launches["patch"], max_abs_err=b3_err,
             ms=times["B3"][0], plain_ms=times["B3"][1], bound_ms=bounds["B3"][0],
             bound_by=bounds["B3"][1], library_ms=b3_library_ms, batched=batch_times["B3"]),
        dict(name="cam_reduce", route="cuda", source="visual_slam_tpu_torch/csrc/seg.cu",
             replaces="visual_slam_tpu/ops/pallas/seg_kernel.py:55",
             launches=launches["cam_reduce"], max_abs_err=path_err["cam_reduce"],
             ms=path_times["B4"][0], plain_ms=path_times["B4"][1],
             bound_ms=path_bounds["B4"][0], bound_by=path_bounds["B4"][1],
             library_ms=path_times["B4"][2]),
        dict(name="cam_expand", route="cuda", source="visual_slam_tpu_torch/csrc/seg.cu",
             replaces="visual_slam_tpu/ops/pallas/seg_kernel.py:83",
             launches=launches["cam_expand"], max_abs_err=path_err["cam_expand"],
             ms=path_times["B5"][0], plain_ms=path_times["B5"][1],
             bound_ms=path_bounds["B5"][0], bound_by=path_bounds["B5"][1],
             library_ms=path_times["B5"][2]),
    ]
    for k in kernels:
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in by_path.items()}
    for (name, C, N, K, ids), (kms, pms, lms, (b, by)) in [
            *seg_times.items(), *(((n, C, N, K, "sharded pose graph"), v)
                                  for (n, C, N, K), v in sharded_times.items())]:
        log(f"[kernels] {name} at C={C}, N={N}, K={K} ({ids} ids): {kms:.4f} ms, plain {pms:.4f} ms, "
            f"library {lms:.4f} ms, bound {b:.4f} ms ({by}): {b / kms:.3f} of the bound")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
