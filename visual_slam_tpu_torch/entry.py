"""Entry points of the port (the counterpart of __graft_entry__.py).

    python -m visual_slam_tpu_torch.entry

runs the tracking step once on the card, prints its output shapes, then
runs `dryrun_multichip` with one rank a card. It exits 1 without a card.

entry():             the main path's tracking step (feature extraction, map
                     matching, tiered PnP) and its example arguments.
dryrun_multichip(n): one step of each multi-rank solve on n ranks: the
                     landmark-sharded BA, the sharded large-map BA, a batched
                     front-end with each rank taking its own frames, the
                     edge-sharded pose graph and the Sim3 pose graph.
dryrun_multihost():  the landmark-sharded BA of the multi-process test over a
                     fleet of (hosts x ranks a host) processes.

Every function runs on the card unless the caller names `device="cpu"`;
without a card the default raises.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .models import ba, frontend
from .models import pose_graph as pg
from .ops import lie, match, pnp
from .parallel import multihost, sharded_ba, sharded_pg
from .parallel.mesh import rank_and_size
from .utils import synthetic

H, W, M = 480, 640, 512  # the entry frame and its snapshot's capacity
ICL_INTR = (481.2, 480.0, 319.5, 239.5)
STEP_FEATURES, STEP_HYPS, STEP_REFINE_ITERS = 512, 128, 5
# The dry run's solves: 2 LM (or GN) iterations of 4 CG iterations each; a
# front-end of 64 features on 64x128 frames.
DRY_ITERS, DRY_CG = 2, 4
DRY_FEATURES, DRY_QUALITY, DRY_NMS = 64, 0.01, 3
# dryrun_multichip's results that every rank holds whole; the others
# (landmarks, features) are each rank's own block.
REPLICATED = ("ba_R", "ba_t", "ba_cost", "large_R", "large_t", "large_cost", "pg_R", "pg_t",
              "pg_cost", "sim3_R", "sim3_t", "sim3_lam", "sim3_cost")
_WORKER = "visual_slam_tpu_torch.parallel.worker"


def entry_arrays() -> tuple:
    """`entry`'s example arguments as NumPy arrays, with the draws of
    `np.random.default_rng(0)` in __graft_entry__.entry's order: (gray
    (H,W), snapshot descriptors (M,8) uint32, xyz (M,3), valid (M,), the
    identity prior R and t, ICL-NUIM intrinsics)."""
    rng = np.random.default_rng(0)
    gray = rng.uniform(0, 1, (H, W)).astype(np.float32)
    snap_xyz = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M), rng.uniform(2, 8, M)],
                        -1).astype(np.float32)
    snap_desc = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    return (gray, snap_desc, snap_xyz, np.ones(M, bool), np.eye(3, dtype=np.float32),
            np.zeros(3, np.float32), np.asarray(ICL_INTR, np.float32))


def track_step(gray, snap_desc, snap_xyz, snap_valid, prev_R, prev_t, intr, generator,
               idx: torch.Tensor | None = None):
    """The tracking step of __graft_entry__.entry: features of `gray`,
    matched against the snapshot, then tiered PnP (prior-seeded GN, RANSAC
    when the prior cannot explain the matches). The JAX step's front-end is
    `extract_fused`, its XLA conv/gather route; the port has only the kernel
    route, kernel B1 then B3, the counterpart of the JAX package's production
    front-end `extract_pallas`. RANSAC's minimal sets are `idx` (128, 6)
    when given, else drawn from `generator`. Returns (R, t, n_in)."""
    feats = frontend.extract(gray, max_features=STEP_FEATURES)
    idx2, _, good = match.match_ratio_test(snap_desc, feats.desc, snap_valid, feats.valid)
    R, t, _, n_in, _ = pnp.solve_pnp_tracked(
        snap_xyz, feats.uv[idx2], intr, good, prev_R, prev_t, idx=idx, generator=generator,
        n_hyps=STEP_HYPS, refine_iters=STEP_REFINE_ITERS)
    return R, t, n_in


def entry(device="cuda"):
    """(track_step, example_args) on `device`: `entry_arrays` moved there
    (descriptors as int32 with the same bits) and a torch.Generator there,
    seeded 0, in the place of the JAX step's PRNGKey(0)."""
    device = torch.device(device)
    gray, desc, xyz, valid, R, t, intr = entry_arrays()
    args = tuple(torch.from_numpy(a).to(device) for a in (gray, desc.view(np.int32), xyz, valid,
                                                             R, t, intr))
    return track_step, (*args, torch.Generator(device=device).manual_seed(0))


def matched_snapshot(feats, intr: torch.Tensor, seed: int = 11) -> tuple:
    """A snapshot of a frame's own features, for `track_step` on that frame:
    their descriptors and validity, and points at depths of 2-8 m along
    their rays (drawn from `np.random.default_rng(seed)`) as seen from a
    camera 3 cm and ~1.3 deg off the identity prior. The step then takes
    its prior-seeded GN branch and lands on that camera; entry()'s own
    random snapshot matches nothing and leaves the pose to RANSAC's DLT.
    `feats` and `intr` on the CPU; returns (desc, xyz, valid) there."""
    uv, intr = feats.uv.double(), intr.double()
    z = torch.from_numpy(np.random.default_rng(seed).uniform(2, 8, len(uv)))
    Xc = torch.stack([(uv[:, 0] - intr[2]) / intr[0] * z, (uv[:, 1] - intr[3]) / intr[1] * z, z], -1)
    R = lie.so3_exp(torch.tensor([0.01, -0.02, 0.005], dtype=torch.float64))
    Xw = (Xc - torch.tensor([0.03, -0.01, 0.02], dtype=torch.float64)) @ R
    return feats.desc, Xw.float(), feats.valid


def dlt_null_vector_bound(Xw: np.ndarray, xn: np.ndarray) -> float:
    """The first-order bound on a backward-stable float32 eigensolver's
    error in the null vector of PnP's row-normalised DLT system
    (ops/pnp.pnp_dlt) over points Xw (S,3) and normalised coordinates xn
    (S,2): 2S u lambda_max / (lambda_2 - lambda_1) of the system's float64
    Gram matrix, u = 2^-24. Two float32 solves of one set may part by twice
    this in R, and in t by twice this times |t|."""
    Xh = np.concatenate([Xw, np.ones((len(Xw), 1))], 1).astype(np.float64)
    z = np.zeros_like(Xh)
    A = np.concatenate([np.concatenate([Xh, z, -xn[:, :1] * Xh], 1),
                        np.concatenate([z, Xh, -xn[:, 1:] * Xh], 1)])
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    lam = np.linalg.eigvalsh(A.T @ A)
    return float(len(A) * 2.0**-24 * lam[-1] / (lam[1] - lam[0]))


def dryrun_problems(n_devices: int) -> dict:
    """The dry run's problems as NumPy arrays, with the draws of
    `np.random.default_rng(0)` in __graft_entry__.dryrun_multichip's order:
    "ba", the keyword arguments of `ba.make_problem` (4 cameras, 64 points,
    camera 0 fixed); "imgs", (n_devices, 64, 128) frames; "chain", a
    32-keyframe chain (R, t, valid); "loop", the Sim3 graph's loop edge
    0 -> 31 (the keyword arguments of `pose_graph.sim3_add_edges`)."""
    rng = np.random.default_rng(0)
    K, P = 4, 64
    X = np.stack([rng.uniform(-1, 1, P), rng.uniform(-1, 1, P), rng.uniform(3, 6, P)],
                 -1).astype(np.float32)
    cam = np.repeat(np.arange(K, dtype=np.int32), P)
    pnt = np.tile(np.arange(P, dtype=np.int32), K)
    intr = np.asarray(ICL_INTR, np.float32)
    uv = np.stack([intr[0] * X[pnt, 0] / X[pnt, 2] + intr[2],
                   intr[1] * X[pnt, 1] / X[pnt, 2] + intr[3]], -1).astype(np.float32)
    cam_fixed = np.zeros(K, bool)
    cam_fixed[0] = True
    t = rng.normal(scale=0.01, size=(K, 3)).astype(np.float32)
    X = X + rng.normal(scale=0.01, size=X.shape).astype(np.float32)
    problem = dict(R=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)), t=t, X=X, cam=cam, pnt=pnt,
                   uv=uv, w=np.ones(len(cam), np.float32), intr=intr, cam_fixed=cam_fixed)
    imgs = rng.uniform(0, 1, (n_devices, 64, 128)).astype(np.float32)
    Kg = 32
    chain = dict(R=np.tile(np.eye(3, dtype=np.float32), (Kg, 1, 1)),
                 t=rng.normal(scale=0.1, size=(Kg, 3)).astype(np.float32), valid=np.ones(Kg, bool))
    loop = dict(e_i=np.array([0], np.int32), e_j=np.array([Kg - 1], np.int32),
                Z_R=np.eye(3, dtype=np.float32)[None], Z_t=np.zeros((1, 3), np.float32),
                Z_ls=np.array([0.05], np.float32), w=np.array([10.0], np.float32))
    return dict(ba=problem, imgs=imgs, chain=chain, loop=loop)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def solve_dryrun(problems: dict, group, device) -> dict:
    """This rank's part of the dry run over `group`, whose size is the
    number of frames: the five solves on `dryrun_problems`. Returns NumPy
    arrays: REPLICATED whole, the landmarks ("ba_X", "large_X") and the
    front-end's features ("fe_*", its frames) of this rank's block."""
    rank, world = rank_and_size(group)
    prob, _ = ba.make_problem(**problems["ba"], device=device)
    out, cost = sharded_ba.optimize_sharded(prob, group, n_iters=DRY_ITERS, cg_iters=DRY_CG)
    big, big_cost = sharded_ba.optimize_large_sharded(prob, group, n_iters=DRY_ITERS,
                                                      cg_iters=DRY_CG)
    imgs = problems["imgs"]
    per = imgs.shape[0] // world
    feats = frontend.extract_batch(imgs[rank * per:(rank + 1) * per], DRY_FEATURES, DRY_QUALITY,
                                   DRY_NMS, device=device)
    R, t, valid = (torch.from_numpy(problems["chain"][k]).to(device) for k in ("R", "t", "valid"))
    R_pg, t_pg, cost_pg = sharded_pg.optimize_sharded(pg.from_keyframe_chain(R, t, valid), group,
                                                      n_iters=DRY_ITERS, cg_iters=DRY_CG)
    gs = pg.sim3_add_edges(pg.sim3_from_keyframe_chain(R, t, valid), **problems["loop"])
    R_s, t_s, lam_s, cost_s = pg.optimize_sim3(gs, n_iters=DRY_ITERS, cg_iters=DRY_CG)
    res = dict(ba_R=out.R, ba_t=out.t, ba_X=out.X, ba_cost=cost, large_R=big.R, large_t=big.t,
               large_X=big.X, large_cost=big_cost, fe_uv=feats.uv, fe_desc=feats.desc,
               fe_score=feats.score, fe_valid=feats.valid, pg_R=R_pg, pg_t=t_pg, pg_cost=cost_pg,
               sim3_R=R_s, sim3_t=t_s, sim3_lam=lam_s, sim3_cost=cost_s)
    return {k: _np(v) for k, v in res.items()}


def solve_multihost(group, device) -> dict:
    """This rank's part of `dryrun_multihost`: the (hosts, ranks a host)
    groups, then the multi-process test's BA (utils/synthetic.
    multihost_problem, 6 LM x 8 CG) landmark-sharded over `group`. Returns
    NumPy arrays: R, t, cost (replicated), X and shard_start (this rank's
    block), host_ranks and cross_ranks (the sizes of its two groups)."""
    host, cross = multihost.host_device_groups()
    prob = synthetic.multihost_problem(device=device)
    out, cost = sharded_ba.optimize_sharded(prob, group, n_iters=6, cg_iters=8, solver="cg")
    ((rows,), X), = multihost.gather_shards(out.X, group)
    return dict(R=_np(out.R), t=_np(out.t), cost=_np(cost), X=X, shard_start=rows.start,
                host_ranks=dist.get_world_size(host), cross_ranks=dist.get_world_size(cross))


def _check_cards(device: torch.device, n_ranks: int) -> None:
    if device.type == "cuda" and torch.cuda.device_count() < n_ranks:
        raise RuntimeError(f"{n_ranks} ranks need {n_ranks} CUDA cards, one a rank; "
                           f"{torch.cuda.device_count()} found")


def _world_of_one(device: torch.device, fn):
    """fn(group, device) in this process on a world of one rank: the
    existing process group, or a new one (NCCL on the card, gloo on the
    CPU) for the call."""
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise ValueError(f"a world of one rank was asked for inside a world of "
                             f"{dist.get_world_size()}")
        return fn(dist.group.WORLD, device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device() if device.index is None
                              else device.index)
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{multihost.free_port()}",
                            world_size=1, rank=0)
    try:
        return fn(dist.group.WORLD, device)
    finally:
        dist.destroy_process_group()


def _fleet(n_ranks: int, device: torch.device, job: dict) -> list[dict]:
    """Run `job` on a fleet of `n_ranks` rank workers (parallel/worker.py),
    one rank a card (NCCL) or CPU ranks (gloo); each rank's NumPy results
    in rank order. Raises on any rank's failure."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as td:
        spec = os.path.join(td, "jobs.json")
        with open(spec, "w") as f:
            json.dump({"jobs": [job]}, f)
        multihost.spawn_worker_fleet(n_ranks, ["-m", _WORKER, "--backend", backend, "--device",
                                               device.type, spec, td])
        out = []
        for r in range(n_ranks):
            with np.load(os.path.join(td, f"{job['name']}.r{r}.npz")) as z:
                out.append({k: z[k] for k in z.files})
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> list[dict]:
    """The dry run on `n_devices` ranks, one a device: in this process for
    one (`_world_of_one`), else a fleet of rank workers. Returns each rank's
    `solve_dryrun` results in rank order. Raises if there are fewer cards
    than ranks, or on any rank's failure."""
    device = torch.device(device)
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs at least one rank, not {n_devices}")
    _check_cards(device, n_devices)
    if n_devices == 1:
        return [_world_of_one(device, lambda group, dev: solve_dryrun(dryrun_problems(1), group,
                                                                        dev))]
    return _fleet(n_devices, device, dict(name="dryrun", kind="dryrun_multichip",
                                          opts=dict(n_devices=n_devices)))


def dryrun_multihost(n_hosts: int = 2, n_local_devices: int = 1, device="cuda") -> list[dict]:
    """The multi-host dry run: `n_hosts * n_local_devices` rank processes,
    one a device, each forming the (hosts, ranks a host) groups and solving
    the landmark-sharded BA of scripts/multihost_ba_worker.py over the
    whole world. Returns each rank's `solve_multihost` results in rank
    order. Raises if there are fewer cards than ranks, or on any rank's
    failure."""
    device = torch.device(device)
    n_ranks = n_hosts * n_local_devices
    _check_cards(device, n_ranks)
    return _fleet(n_ranks, device, dict(name="multihost", kind="dryrun_multihost"))


def main() -> int:
    if not torch.cuda.is_available():
        print("entry: no CUDA card; entry(device='cpu') runs the step on the CPU", file=sys.stderr)
        return 1
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry OK:", [tuple(o.shape) for o in out])
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
