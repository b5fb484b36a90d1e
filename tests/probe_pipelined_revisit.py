"""The pipelined driver of the JAX package and of the port on the revisiting
scene, on the CPU; prints one JSON line per run (ATE, closures, keyframes,
re-tracks):

    JAX_PLATFORMS=cpu python tests/probe_pipelined_revisit.py [--half] [--serial]

Full size (640x480, K=1024, M=2048, default settings, 480 frames) by
default; --half runs tests/test_torch_loop_slam.py's half-size scene (240
frames). --serial adds both packages' serial loops. The JAX run's fetch
pool is replaced by never-done futures, as in tests/test_torch_pipelined.py,
so it takes the count branch the port takes. About 8 minutes at full size.
"""
import argparse
import concurrent.futures
import json
import sys
import time
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_pipelined import _LazyExecutor  # noqa: E402
from torch_parity import ICL_INTR  # noqa: E402

from visual_slam_tpu import pipeline as jpipeline  # noqa: E402
from visual_slam_tpu.config import SlamConfig as JSlamConfig  # noqa: E402
from visual_slam_tpu_torch import pipeline as tpipeline  # noqa: E402
from visual_slam_tpu_torch.config import SlamConfig  # noqa: E402
from visual_slam_tpu_torch.utils import evaluate  # noqa: E402
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene  # noqa: E402


def config(cls, half):
    if not half:
        return cls(use_depth=True)
    cfg = cls(use_depth=True, intrinsics=ICL_INTR / 2)
    cfg.frontend.max_features, cfg.map.track_capacity = 256, 512
    cfg.keyframe.max_interval, cfg.loop.min_gap = 10, 8
    return cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--half", action="store_true")
    ap.add_argument("--serial", action="store_true")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    if args.half:
        scene = SyntheticRGBDScene(240, 240, 320, intrinsics=ICL_INTR / 2, trajectory="revisit")
    else:
        scene = SyntheticRGBDScene(480, trajectory="revisit")
    frames, gt = list(scene.frames()), scene.ground_truth()
    runs = [("jax", True), ("port", True)] + ([("jax", False), ("port", False)] if args.serial else [])
    for side, pipelined in runs:
        t0 = time.perf_counter()
        if side == "jax":
            slam = jpipeline.Slam(config(JSlamConfig, args.half))
            if pipelined:
                pool = concurrent.futures.ThreadPoolExecutor
                concurrent.futures.ThreadPoolExecutor = _LazyExecutor
                try:
                    jpipeline.run_pipelined(slam, iter(frames), 8)
                finally:
                    concurrent.futures.ThreadPoolExecutor = pool
        else:
            slam = tpipeline.Slam(config(SlamConfig, args.half), device="cpu")
            if pipelined:
                tpipeline.run_pipelined(slam, iter(frames), 8)
        if not pipelined:
            for i, gray, depth in frames:
                slam.process(i, gray, depth)
        traj = sorted(slam.trajectory, key=lambda f: f.frame_idx)
        idxs = np.array([f.frame_idx for f in traj])
        est = np.stack([-f.R_cw.T @ f.t_cw for f in traj])
        ate, _ = evaluate.ate_rmse(est, gt[idxs, :3, 3], align_scale=False)
        st = slam.stats
        print(json.dumps(dict(
            side=side, driver="pipelined" if pipelined else "serial", half=args.half,
            seconds=round(time.perf_counter() - t0, 1),
            ate_m=ate, frames=len(idxs), keyframes=[int(f.frame_idx) for f in traj if f.is_keyframe],
            **{k: st.get(k, 0) for k in ("loop_closures", "ba_runs", "track_failures", "fail_retried_ok",
                                         "kf_vetoed_stale", "kf_retracked")})), flush=True)


if __name__ == "__main__":
    main()
