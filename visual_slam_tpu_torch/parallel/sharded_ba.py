"""Distributed bundle adjustment: landmark-sharded Schur elimination over a
torch.distributed process group (port of visual_slam_tpu/parallel/
sharded_ba.py).

The landmark axis is partitioned across ranks, and with it each landmark's
observation slots (the planar (P, Q) layout keeps a point's slots
contiguous): rank r of W holds landmarks [r P/W, (r+1) P/W) and slots
[r N/W, (r+1) N/W). The camera side (R, t, intrinsics, the gauge mask, the
scale edges) is replicated. Each rank builds its partial camera-side terms
from its own landmarks, with its own B4 reduce plan over its own slots and
the global camera count; `ba._allreduce` sums them at the JAX package's
psum points. The landmark side never crosses a rank.

The result matches the one-device solve up to the order of the float32
camera sums; with one rank it is the same solve, bit for bit.
"""
from __future__ import annotations

from ..models import ba as ba_mod
from ..models import ba_large
from .mesh import rank_and_size

# BAProblem fields with the landmark axis first, and the (2,N) slot planes.
_POINT_FIELDS = ("X", "pt_valid")
_SLOT_FIELDS = ("cam", "w", "dinv", "dw")


def shard_problem(p: ba_mod.BAProblem, rank: int, world: int) -> ba_mod.BAProblem:
    """Rank `rank`'s contiguous block of a full problem, of a world of
    `world` ranks: its landmarks and their slots; the camera side whole.
    The counterpart of `problem_specs`."""
    P, N = p.X.shape[0], p.cam.shape[0]
    if P % world:
        raise ValueError(f"landmark count {P} not divisible by world size {world}")
    per, Q = P // world, N // P
    pts, slots = slice(rank * per, (rank + 1) * per), slice(rank * per * Q, (rank + 1) * per * Q)
    cut = {f: getattr(p, f)[pts].contiguous() for f in _POINT_FIELDS}
    cut.update({f: getattr(p, f)[slots].contiguous() for f in _SLOT_FIELDS})
    cut["uv"] = p.uv[:, slots].contiguous()
    return p._replace(**cut)


def optimize_sharded(p: ba_mod.BAProblem, group, n_iters: int = 10, cg_iters: int = 12,
                     points_fixed: bool = False, solver: str = "chol", use_depth: bool = False):
    """LM-Schur bundle adjustment (models/ba.optimize) with the landmarks of
    the full problem `p` sharded over `group`. Every rank passes the same
    `p`. Returns (this rank's block of the solved problem, the cost): R and
    t are replicated, X is the rank's block (multihost.gather_shards).

    The packed landmark count is a power of two >= 64 (ba.make_problem),
    so it divides any power-of-two world."""
    local = shard_problem(p, *rank_and_size(group))
    return ba_mod.optimize(local, n_iters=n_iters, cg_iters=cg_iters, points_fixed=points_fixed,
                           solver=solver, use_depth=use_depth, group=group)


def optimize_large_sharded(p: ba_mod.BAProblem, group, n_iters: int = 10, cg_iters: int = 12,
                           points_fixed: bool = False, init_lambda: float = 1e-4):
    """Landmark-sharded large-map bundle adjustment (BASELINE config #5):
    the same contract as optimize_sharded, the per-rank solver
    models/ba_large.optimize (memory linear in the slots, B4/B5)."""
    local = shard_problem(p, *rank_and_size(group))
    return ba_large.optimize(local, n_iters=n_iters, cg_iters=cg_iters, points_fixed=points_fixed,
                             init_lambda=init_lambda, group=group)
