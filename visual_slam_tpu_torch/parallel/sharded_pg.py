"""Edge-sharded pose-graph Gauss-Newton over a torch.distributed process
group (port of visual_slam_tpu/parallel/sharded_pg.py).

The edge tables (SE3 relative-pose edges and scale edges, the reference's
g2o EdgeSE3 / EdgeSBAScale chains, LocalBA.py:97-131) are partitioned
across ranks; the poses are replicated (a 5k-keyframe graph is 5k x 12
floats). Each rank sums its edges' contributions to the block diagonal,
the gradient, each CG matvec and the cost with its own B4 plan over its
own slots [e_i, e_j, s_i, s_j]; models/pose_graph.optimize all-reduces
them at the JAX package's psum points.

Communication per GN step, K keyframes, float32: one (42,K) all-reduce
(K*168 bytes) and the cost, then cg_iters x (6,K) (K*24 bytes each).
`optimize_sim3` stays unsharded, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..models import pose_graph as pg_mod
from .mesh import rank_and_size

_SE3_FIELDS = ("e_i", "e_j", "Z_R", "Z_t", "w")
_SCALE_FIELDS = ("s_i", "s_j", "s_meas", "s_w")


def _pad(x: torch.Tensor, k: int, fill=0) -> torch.Tensor:
    if k == 0:
        return x
    return torch.cat([x, torch.full((k, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)])


def pad_edges(g: pg_mod.PoseGraph, n: int) -> pg_mod.PoseGraph:
    """Pad the SE3 and scale edge tables to multiples of `n` with
    zero-weight identity edges at vertex 0: a weight-0 edge adds exactly
    zero to every sum."""
    k, s = (-g.e_i.shape[0]) % n, (-g.s_i.shape[0]) % n
    eye = torch.eye(3, dtype=g.Z_R.dtype, device=g.Z_R.device).expand(k, 3, 3)
    return g._replace(
        e_i=_pad(g.e_i, k), e_j=_pad(g.e_j, k), Z_R=torch.cat([g.Z_R, eye]), Z_t=_pad(g.Z_t, k),
        w=_pad(g.w, k), s_i=_pad(g.s_i, s), s_j=_pad(g.s_j, s), s_meas=_pad(g.s_meas, s, 1),
        s_w=_pad(g.s_w, s),
    )


def shard_graph(g: pg_mod.PoseGraph, rank: int, world: int) -> pg_mod.PoseGraph:
    """Rank `rank`'s contiguous block of each edge table (their lengths
    multiples of `world`, see pad_edges); the poses and `fixed` whole. The
    counterpart of `graph_specs`."""
    E, S = g.e_i.shape[0], g.s_i.shape[0]
    if E % world or S % world:
        raise ValueError(f"edge tables of {E} and {S} not divisible by world size {world}")
    se3 = slice(rank * E // world, (rank + 1) * E // world)
    scale = slice(rank * S // world, (rank + 1) * S // world)
    cut = {f: getattr(g, f)[se3].contiguous() for f in _SE3_FIELDS}
    cut.update({f: getattr(g, f)[scale].contiguous() for f in _SCALE_FIELDS})
    return g._replace(**cut)


def optimize_sharded(g: pg_mod.PoseGraph, group, n_iters: int = 12, cg_iters: int = 32,
                     use_dcs: bool = True):
    """Pose-graph GN (models/pose_graph.optimize) with the edges of the full
    graph `g` sharded over `group`; every rank passes the same `g`. Pads
    the edge tables to the world size and returns (R, t, cost), replicated
    on every rank."""
    rank, world = rank_and_size(group)
    local = shard_graph(pad_edges(g, world), rank, world)
    return pg_mod.optimize(local, n_iters=n_iters, cg_iters=cg_iters, use_dcs=use_dcs, group=group)
