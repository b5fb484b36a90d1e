"""BASELINE.json config #5: large-map BA at ~5k keyframes and ~1M landmarks
(port of scripts/large_map_bench.py).

    python -m visual_slam_tpu_torch.large_map --kf 5000 --pts 1048576 \\
        --obs-per-pt 4 --iters 5 --cg-iters 8 --lm-lambda 1e-2
    python -m visual_slam_tpu_torch.large_map --ranks 1 2 4 --backend gloo

Builds the synthetic loop map (utils/synthetic.build_loop_map) on the card,
runs the memory-linear large-map solver (models/ba_large.optimize) twice, a
first (cold) run and a warm one, checks convergence (cost drop and pose
recovery) and prints one JSON line last. `--ranks N [M ...]` (the JAX
script's --devices / --sweep) solves it landmark-sharded over N ranks
(parallel/sharded_ba.optimize_large_sharded), spawned through
multihost.spawn_worker_fleet, each rank on card rank % cards; the line then
holds one run per rank count. `--backend nccl` wants a card a rank; ranks
sharing one card need `--backend gloo`. Needs a CUDA card: the measurement
does not fall back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .models import ba_large
from .models.ba import BAProblem
from .ops.kernels import seg_kernel
from .parallel import multihost
from .utils.synthetic import build_loop_map

COST_DROP = 0.05  # cost_after < COST_DROP * cost_before (tests/test_ba_large.py:60)


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(prob: BAProblem, gt, n_iters: int, cg_iters: int,
        lm_lambda: float) -> tuple[dict, BAProblem]:
    """Solve `prob` twice, a first and a warm run of the same optimize.
    Returns (the script's numbers, the warm run's problem).

    `launches_per_optimize` counts the B4/B5 launches of the warm run alone;
    `cost_after_first` is the first run's final cost, the warm run's to the
    bit (every sum on the path adds in a fixed order).
    """
    t_gt = gt[1]
    device = prob.R.device
    _sync(device)
    t0 = time.perf_counter()
    out, cost = ba_large.optimize(prob, n_iters=n_iters, cg_iters=cg_iters, init_lambda=lm_lambda)
    cost_first = float(cost)  # waits for the device
    t_first = time.perf_counter() - t0
    n_red, n_exp = seg_kernel.reduce_launches, seg_kernel.expand_launches
    t0 = time.perf_counter()
    out, cost = ba_large.optimize(prob, n_iters=n_iters, cg_iters=cg_iters, init_lambda=lm_lambda)
    cost_after = float(cost)
    t_warm = time.perf_counter() - t0
    launches = {"cam_reduce": seg_kernel.reduce_launches - n_red,
                "cam_expand": seg_kernel.expand_launches - n_exp}
    cost_before = float(ba_large._cost(prob))
    t_err0 = float(np.abs(prob.t.cpu().numpy() - t_gt).max())
    t_err = float(np.abs(out.t.cpu().numpy() - t_gt).max())
    return dict(
        keyframes=prob.R.shape[0],
        landmarks=prob.X.shape[0],
        observations=prob.cam.shape[0],
        lm_iters=n_iters,
        cg_iters=cg_iters,
        iters_per_s=n_iters / t_warm,
        wall_s_warm=t_warm,
        wall_s_first=t_first,
        cost_before=cost_before,
        cost_after=cost_after,
        cost_after_first=cost_first,
        max_t_err_m=t_err,
        max_t_err_m_before=t_err0,
        launches_per_optimize=launches,
    ), out


def check(res: dict) -> None:
    """Raise unless the solve converged (the cost falls below COST_DROP of
    its start and the worst translation error falls) and repeated (the first
    and the warm run end on the same cost, bit for bit)."""
    if res["cost_after"] != res["cost_after_first"]:
        raise AssertionError(f"first and warm runs differ: cost {res['cost_after_first']!r} "
                             f"vs {res['cost_after']!r}")
    if not res["cost_after"] < COST_DROP * res["cost_before"]:
        raise AssertionError(f"cost {res['cost_before']} -> {res['cost_after']}: "
                             f"not below {COST_DROP} of the start")
    if not res["max_t_err_m"] < res["max_t_err_m_before"]:
        raise AssertionError(f"max translation error {res['max_t_err_m_before']} -> "
                             f"{res['max_t_err_m']}: did not fall")


def run_ranks(ranks: int, backend: str, problem: dict, cost_before: float, t_err0: float,
              t_gt: np.ndarray, n_iters: int, cg_iters: int, lm_lambda: float) -> dict:
    """Solve the loop map `problem` (build_loop_map's arguments) sharded over
    `ranks` worker ranks, a first and a warm solve. Returns run()'s numbers
    for it, with each rank's peak memory, B4/B5 launches and all-reduces."""
    with tempfile.TemporaryDirectory() as tmp:
        job = dict(name="config5", kind="large", problem=dict(synthetic="loop_map", **problem),
                   opts=dict(n_iters=n_iters, cg_iters=cg_iters, init_lambda=lm_lambda), repeat=2)
        spec = os.path.join(tmp, "jobs.json")
        with open(spec, "w") as f:
            json.dump({"jobs": [job]}, f)
        logs = multihost.spawn_worker_fleet(ranks, ["-m", "visual_slam_tpu_torch.parallel.worker",
                                                    "--backend", backend, spec, tmp])
        out = [dict(np.load(os.path.join(tmp, f"config5.r{r}.npz"))) for r in range(ranks)]
    for line in logs:
        print(line.strip(), file=sys.stderr)
    r0 = out[0]
    if any(not np.array_equal(o["t"], r0["t"]) or o["cost"] != r0["cost"] for o in out):
        raise AssertionError(f"{ranks} ranks ended on different poses or costs")
    walls = np.array([o["walls"] for o in out])  # (ranks, 2): first, warm
    return dict(
        ranks=ranks, backend=backend, lm_iters=n_iters, cg_iters=cg_iters,
        iters_per_s=n_iters / float(walls[:, 1].max()),
        wall_s_warm=float(walls[:, 1].max()), wall_s_first=float(walls[:, 0].max()),
        cost_before=cost_before, cost_after=float(r0["costs"][1]),
        cost_after_first=float(r0["costs"][0]),
        max_t_err_m=float(np.abs(r0["t"] - t_gt).max()), max_t_err_m_before=t_err0,
        peak_mem_gb=[float(o["peak_mem_bytes"]) / 1e9 for o in out],
        launches_per_optimize=[{"cam_reduce": int(o["reduce_launches"]),
                                "cam_expand": int(o["expand_launches"])} for o in out],
        allreduce_bytes_per_iter=float(r0["allreduce_bytes"]) / n_iters,
        # one more solve under torch.profiler: each rank's ms inside its
        # all-reduces an iteration, and their share of that solve's wall
        allreduce_ms_per_iter=[float(o["allreduce_ms"]) / n_iters for o in out],
        allreduce_share=[float(o["allreduce_ms"]) / (1e3 * float(o["profiled_wall_s"]))
                         for o in out],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kf", type=int, default=5000)
    ap.add_argument("--pts", type=int, default=1 << 20)
    ap.add_argument("--obs-per-pt", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cg-iters", type=int, default=8)
    ap.add_argument("--lm-lambda", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, nargs="+", default=[1],
                    help="rank counts to solve with (1: in this process, unsharded)")
    ap.add_argument("--backend", default="nccl", choices=multihost.BACKENDS,
                    help="process-group backend of the sharded runs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("large_map: no CUDA card; this measurement runs only on one", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    K, P, Q = args.kf, args.pts, args.obs_per_pt
    print(f"building synthetic map: {K} keyframes, {P} landmarks, {P * Q} observations",
          file=sys.stderr)
    t0 = time.perf_counter()
    prob, gt = build_loop_map(K, P, Q, seed=args.seed, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    if args.ranks == [1]:
        torch.cuda.reset_peak_memory_stats(dev)
        res, _ = run(prob, gt, args.iters, args.cg_iters, args.lm_lambda)
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        res["build_s"] = build_s
        res["device"] = device_line()
        check(res)
        print(json.dumps({"metric": "config#5 large-map BA (synthetic)", **res}))
        return 0
    cost_before = float(ba_large._cost(prob))
    t_err0 = float(np.abs(prob.t.cpu().numpy() - gt[1]).max())
    runs = []
    for n in args.ranks:
        if n == 1:
            res, _ = run(prob, gt, args.iters, args.cg_iters, args.lm_lambda)
            res["ranks"] = 1
        else:
            res = run_ranks(n, args.backend, dict(K=K, P=P, Q=Q, seed=args.seed), cost_before,
                            t_err0, gt[1], args.iters, args.cg_iters, args.lm_lambda)
        check(res)
        runs.append(res)
    print(json.dumps({"metric": "config#5 large-map BA (synthetic)", "keyframes": K,
                      "landmarks": P, "observations": P * Q, "build_s": build_s,
                      "device": device_line(), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
