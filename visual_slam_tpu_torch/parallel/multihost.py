"""Multi-process execution: torch.distributed wiring and the shard helpers
(port of visual_slam_tpu/parallel/multihost.py).

Processes join one process group from VSLAM_* environment variables over
TCP (`initialize_from_env`); the landmark-sharded BA (sharded_ba) and the
edge-sharded pose graph (sharded_pg) then run over it. The backend is the
caller's choice: "nccl" where each rank owns a card, "gloo" on the CPU or
for several ranks sharing one card. There is no automatic switch.

Tested without several hosts by spawning CPU ranks on gloo
(`spawn_worker_fleet`, the worker `python -m
visual_slam_tpu_torch.parallel.worker`); the result is held to the
single-process solver.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import sharded_ba
from .mesh import rank_and_size

BACKENDS = ("nccl", "gloo")
_REPO = Path(__file__).resolve().parents[2]


def initialize_from_env(backend: str) -> int:
    """Join the process group from VSLAM_COORDINATOR (host:port),
    VSLAM_NUM_PROCESSES and VSLAM_PROCESS_ID, with `backend` ("nccl" or
    "gloo"). Returns this process's rank; a no-op that returns 0 when the
    variables are absent (a single-process run)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    coord = os.environ.get("VSLAM_COORDINATOR")
    if not coord:
        return 0
    rank = int(os.environ["VSLAM_PROCESS_ID"])
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=int(os.environ["VSLAM_NUM_PROCESSES"]), rank=rank)
    return rank


def global_group():
    """The group of every rank of every host (the counterpart of
    `global_mesh`)."""
    return dist.group.WORLD


def host_device_groups():
    """(this host's group, this rank's cross-host group): the rows and
    columns of the (hosts, ranks a host) grid, the counterpart of
    `host_device_mesh`. Collectives over the host group stay on the host;
    only the cross-host group's cross the network. Collective: every rank
    calls it. Hosts are told apart by name and must hold as many ranks each."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    hosts = sorted(set(names), key=names.index)
    rows = [[r for r, h in enumerate(names) if h == host] for host in hosts]
    if len({len(row) for row in rows}) != 1:
        raise ValueError(f"hosts hold different numbers of ranks: {[len(r) for r in rows]}")
    cols = [list(c) for c in zip(*rows)]
    host_group, _ = dist.new_subgroups_by_enumeration(rows)
    cross_group, _ = dist.new_subgroups_by_enumeration(cols)
    return host_group, cross_group


def make_global_problem(p, group):
    """This process's shard of a full BAProblem that every process built
    from the same seed (sharded_ba.shard_problem at the group's rank)."""
    return sharded_ba.shard_problem(p, *rank_and_size(group))


def gather_shards(x: torch.Tensor, group) -> list[tuple[tuple, np.ndarray]]:
    """This process's (index, data) shards of a landmark-sharded array: one
    shard, rank r's block of rows [r n, (r+1) n)."""
    rank, _ = rank_and_size(group)
    n = x.shape[0]
    return [((slice(rank * n, (rank + 1) * n),), x.detach().cpu().numpy())]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tail(f, n: int = 3000) -> str:
    f.seek(0)
    return f.read().decode(errors="replace")[-n:]


def spawn_worker_fleet(n_processes: int, worker_argv: list[str],
                       timeout_s: float = 420.0) -> list[str]:
    """Spawn `n_processes` Python processes running `worker_argv` that join
    one process group (VSLAM_* variables), wait for all, and return their
    combined stdout and stderr logs in rank order.

    Picks a free coordinator port (a stale process on a fixed port would
    hang every later fleet), writes each log to a temporary file rather
    than a pipe (a worker blocked on a full pipe would stall the collectives
    every other worker waits in), and kills the whole fleet on any failure
    or timeout, so no worker outlives its launch.
    Raises RuntimeError with the log's tail on a non-zero exit or a timeout.
    """
    base = dict(os.environ, VSLAM_COORDINATOR=f"localhost:{free_port()}",
                VSLAM_NUM_PROCESSES=str(n_processes))
    procs, files = [], []
    try:
        for rank in range(n_processes):
            f = tempfile.TemporaryFile()
            files.append(f)
            procs.append(subprocess.Popen(
                [sys.executable, *worker_argv], env=dict(base, VSLAM_PROCESS_ID=str(rank)),
                stdout=f, stderr=subprocess.STDOUT, cwd=_REPO))
        deadline = time.monotonic() + timeout_s
        # Poll the whole fleet: a rank that fails leaves the others waiting
        # in a collective, so the first failure ends the wait.
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"worker fleet timed out after {timeout_s} s:\n"
                                   + _tail(files[0]))
            time.sleep(0.05)
        for rank, (p, f) in enumerate(zip(procs, files)):
            if p.returncode not in (None, 0):
                raise RuntimeError(f"worker rank {rank} exited {p.returncode}:\n{_tail(f)}")
        logs = []
        for f in files:
            f.seek(0)
            logs.append(f.read().decode(errors="replace"))
        return logs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
