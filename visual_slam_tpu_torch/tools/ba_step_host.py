#!/usr/bin/env python3
"""Host time of one keyframe BA step on the card, to set two checkouts of
the port side by side on one machine.

    python3 visual_slam_tpu_torch/tools/ba_step_host.py [--root DIR] [--rounds 5] [--calls 10]

Imports visual_slam_tpu_torch from DIR (default: the checkout holding this
file), runs the RGB-D SLAM loop of chip_smoke.py's phase 6 (60 synthetic
640x480 frames) for its final map, and times `pipeline.ba_step` on that
map's BA problem: `rounds` times, `calls` steps queued back to back and one
synchronise, ms per step. A step never waits for the card and its device
work (~21 ms) is a fraction of its host work, so this is the host's time.
Beside it, the host ms per call of kernel B4 at the step's (42,N) shape,
of kernel B5 at its (12,K) -> (12,N) one and, where the checkout has one,
of building B4's reduce plan. Prints the card's name and power limit, then
one JSON line. Run the checkouts in turns (a, b, b, a): the host's speed
drifts between processes.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time


def host_ms(fn, calls, sync) -> float:
    """Wall ms per call over `calls` calls queued back to back, then one
    synchronise."""
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ba_step_host: no CUDA card", file=sys.stderr)
        return 1
    from visual_slam_tpu_torch.config import SlamConfig
    from visual_slam_tpu_torch.ops.kernels import build, seg_kernel
    from visual_slam_tpu_torch.pipeline import ba_step, run_sequence
    from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

    class Frames:
        def __init__(self, frames):
            self._frames = frames

        def frames(self, start=0, stop=None):
            yield from self._frames[start:stop]

    dev = torch.device("cuda", 0)
    build.build()
    build.library()
    rendered = list(SyntheticRGBDScene(60).frames())
    cfg = SlamConfig(use_depth=True)
    slam = run_sequence(Frames(rendered), cfg, device=dev)
    prob, _ = slam.map.to_ba_problem(cfg.intrinsics, depth_weight=cfg.ba.depth_weight, device=dev)
    K, N = prob.R.shape[0], prob.cam.shape[0]
    sync = torch.cuda.synchronize

    def step():
        return ba_step(prob, cfg.ba.iters, cfg.ba.cg_iters, cfg.ba.solver, use_depth=True)

    for _ in range(2):
        step()
    steps = [host_ms(step, args.calls, sync) for _ in range(args.rounds)]
    rows = torch.from_numpy(np.random.default_rng(0).normal(size=(42, N)).astype(np.float32)).to(dev)
    if hasattr(seg_kernel, "reduce_plan"):
        plan = seg_kernel.reduce_plan(prob.cam, K)
        plan_ms = host_ms(lambda: seg_kernel.reduce_plan(prob.cam, K), 200, sync)
        reduce_ms = host_ms(lambda: seg_kernel.cam_reduce(rows, prob.cam, K, plan), 200, sync)
    else:
        plan_ms = None
        reduce_ms = host_ms(lambda: seg_kernel.cam_reduce(rows, prob.cam, K), 200, sync)
    table = rows[:12, :K].contiguous()
    expand_ms = host_ms(lambda: seg_kernel.cam_expand(table, prob.cam), 200, sync)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({
        "root": args.root, "K": K, "N": N, "lm_iters": cfg.ba.iters,
        "ba_step_host_ms": steps, "ba_step_host_ms_median": statistics.median(steps),
        "b4_call_host_ms": reduce_ms, "b4_plan_host_ms": plan_ms, "b5_call_host_ms": expand_ms,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
