"""One rank of a sharded solve (the counterpart of
scripts/multihost_ba_worker.py).

    python -m visual_slam_tpu_torch.parallel.worker --backend gloo \\
        --device cpu JOBS.json OUT_DIR

Launched once per rank by multihost.spawn_worker_fleet, which sets the
VSLAM_* variables. The rank joins the process group, then runs each job of
JOBS.json in turn: builds the full problem (every rank the same one, from a
file or from a seed), solves it sharded over the whole world `repeat`
times, and writes OUT_DIR/<name>.r<rank>.npz:

  R, t, cost          the last solve's (replicated) result
  X, shard_start      BA jobs: this rank's block of the landmarks
  costs, walls        each solve's cost and wall seconds (synchronised)
  reduce_launches, expand_launches   B4 and B5 launches of the last solve
  allreduce_calls, allreduce_bytes   the all-reduces of the last solve
  allreduce_ms, allreduce_spans, profiled_wall_s
                      one more solve, under torch.profiler: the time this
                      rank spent inside its all-reduces (the profiler's
                      "<backend>:all_reduce" spans, each from the call to
                      its end), their number, and the solve's wall seconds
  peak_mem_bytes      the device's peak memory (CUDA; -1 on the CPU)

A job is {"name", "kind": "ba" | "large" | "pg", "problem": {...},
"opts": {...}, "repeat": n}. "opts" are the keyword arguments of
sharded_ba.optimize_sharded, optimize_large_sharded or
sharded_pg.optimize_sharded. "problem" is {"npz": path} (the arrays of a
BAProblem or PoseGraph) or {"synthetic": "loop_map" | "big_pose_graph" |
"multihost", ...its keyword arguments} (utils/synthetic).

The dry runs of entry.py are jobs of their own, {"name", "kind":
"dryrun_multichip", "opts": {"n_devices": n}} and {"name", "kind":
"dryrun_multihost"}: the rank runs entry.solve_dryrun or
entry.solve_multihost once and writes what it returns.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import convert
from ..models import ba as ba_mod
from ..ops.kernels import seg_kernel
from ..utils import synthetic
from . import multihost, sharded_ba, sharded_pg


def load_problem(spec: dict, kind: str, device):
    """The full problem of a job on `device`."""
    if "npz" in spec:
        with np.load(spec["npz"]) as z:
            arrays = {k: z[k] for k in z.files}
        if kind == "pg":
            return convert.from_jax_pose_graph(arrays, device)
        return convert.from_jax_ba_problem(arrays, device)
    args = {k: v for k, v in spec.items() if k != "synthetic"}
    maker = spec["synthetic"]
    if maker == "loop_map":
        return synthetic.build_loop_map(**args, device=device)[0]
    if maker == "big_pose_graph":
        return synthetic.big_pose_graph(**args, device=device)[0]
    if maker == "multihost":
        return synthetic.multihost_problem(**args, device=device)
    raise ValueError(f"unknown synthetic problem {maker!r}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _solve(kind: str, prob, group, opts: dict):
    if kind == "ba":
        return sharded_ba.optimize_sharded(prob, group, **opts)
    if kind == "large":
        return sharded_ba.optimize_large_sharded(prob, group, **opts)
    if kind == "pg":
        return sharded_pg.optimize_sharded(prob, group, **opts)
    raise ValueError(f"unknown job kind {kind!r}")


def profile_allreduces(kind: str, prob, group, opts: dict, device) -> tuple[float, int, float]:
    """Solve once more under torch.profiler. Returns (ms this rank spent
    inside all-reduces, their number, the solve's wall seconds). A span
    runs from the all-reduce's call to its end, so it holds the wait for the
    other ranks and, on gloo with a card's tensor, the wait for this rank's
    queued kernels before the tensor is copied to the host."""
    from torch.profiler import ProfilerActivity, profile, record_function

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # after the profiler starts, which takes each rank its own time
        dist.barrier(group=group)
        with record_function("solve"):
            t0 = time.perf_counter()
            float(_solve(kind, prob, group, opts)[-1])  # waits for the device
            wall = time.perf_counter() - t0
    events = prof.events()
    start = next(e for e in events if e.name == "solve").time_range.start
    # NCCL's barrier is an all-reduce of its own: only the solve's count
    spans = [e.cpu_time_total for e in events
             if e.name.endswith(":all_reduce") and e.time_range.start >= start]
    return sum(spans) / 1e3, len(spans), wall


def run_job(job: dict, group, device, out_dir: str) -> str:
    """Run one job on this rank; write its npz; return its log line."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    kind, opts = job["kind"], job.get("opts", {})
    if kind in ("dryrun_multichip", "dryrun_multihost"):
        from .. import entry  # imports this package

        res = (entry.solve_dryrun(entry.dryrun_problems(opts["n_devices"]), group, device)
               if kind == "dryrun_multichip" else entry.solve_multihost(group, device))
        np.savez(os.path.join(out_dir, f"{job['name']}.r{rank}.npz"), **res)
        return f"rank {rank}/{world} {job['name']}: {kind} done"
    prob = load_problem(job["problem"], kind, device)
    costs, walls = [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(max(1, int(job.get("repeat", 1)))):
        seg_kernel.reduce_launches = seg_kernel.expand_launches = 0
        ba_mod.allreduce_calls = ba_mod.allreduce_bytes = 0
        _sync(device)
        dist.barrier(group=group)
        t0 = time.perf_counter()
        out = _solve(kind, prob, group, opts)
        cost = float(out[-1])  # waits for the device
        walls.append(time.perf_counter() - t0)
        costs.append(cost)
    res = dict(cost=np.float32(cost), costs=np.asarray(costs), walls=np.asarray(walls),
               reduce_launches=seg_kernel.reduce_launches,
               expand_launches=seg_kernel.expand_launches,
               allreduce_calls=ba_mod.allreduce_calls, allreduce_bytes=ba_mod.allreduce_bytes,
               peak_mem_bytes=(torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else -1),
               world=world, rank=rank)
    if kind == "pg":
        res.update(R=out[0].cpu().numpy(), t=out[1].cpu().numpy())
    else:
        solved = out[0]
        ((rows,), X), = multihost.gather_shards(solved.X, group)
        res.update(R=solved.R.cpu().numpy(), t=solved.t.cpu().numpy(), X=X,
                   shard_start=rows.start)
    res["allreduce_ms"], res["allreduce_spans"], res["profiled_wall_s"] = profile_allreduces(
        kind, prob, group, opts, device)
    np.savez(os.path.join(out_dir, f"{job['name']}.r{rank}.npz"), **res)
    n_it = opts.get("n_iters", 12 if kind == "pg" else 10)
    return (f"rank {rank}/{world} {job['name']}: cost {cost!r}, warm {n_it / walls[-1]:.2f} "
            f"iters/s, B4 {res['reduce_launches']} B5 {res['expand_launches']}, all-reduce "
            f"{res['allreduce_calls']} calls {res['allreduce_bytes']} B "
            f"({res['allreduce_bytes'] / n_it:.0f} B an iteration; profiled, "
            f"{res['allreduce_ms'] / n_it:.3f} ms inside them of a "
            f"{1e3 * res['profiled_wall_s'] / n_it:.3f} ms iteration), peak "
            f"{res['peak_mem_bytes'] / 1e9:.3f} GB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", required=True, choices=multihost.BACKENDS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("jobs")
    ap.add_argument("out_dir")
    args = ap.parse_args(argv)
    # One intra-op thread: torch's CPU sqrt on a second thread once returned
    # a chunk of roots off in the last bits (ROADMAP Queue C, Fixed).
    torch.set_num_threads(1)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("worker: no CUDA card", file=sys.stderr)
            return 1
        rank = int(os.environ.get("VSLAM_PROCESS_ID", "0"))
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    multihost.initialize_from_env(args.backend)
    if not dist.is_initialized():
        print("worker: VSLAM_COORDINATOR is not set; start it with spawn_worker_fleet",
              file=sys.stderr)
        return 1
    with open(args.jobs) as f:
        jobs = json.load(f)["jobs"]
    group = multihost.global_group()
    try:
        for job in jobs:
            print(run_job(job, group, device, args.out_dir), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
