"""Process-group helpers for multi-rank solves (port of
visual_slam_tpu/parallel/mesh.py).

The JAX package lays a 1-D `jax.sharding.Mesh` over devices and runs its
solvers under shard_map. Here a rank of a torch.distributed process group
is one process on one device: the group takes the mesh's place, its size
the mesh size and a rank's index its position on the mesh axis.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist


def make_group(n_ranks: int | None = None):
    """The process group of the first `n_ranks` ranks (default: all), the
    counterpart of `make_mesh`. Collective: every rank of the world calls
    it. Ranks outside the group get None."""
    world = dist.get_world_size()
    if n_ranks is None or n_ranks == world:
        return dist.group.WORLD
    if not 1 <= n_ranks <= world:
        raise ValueError(f"make_group: {n_ranks} ranks of a world of {world}")
    group = dist.new_group(list(range(n_ranks)))
    return group if dist.get_rank() < n_ranks else None


def rank_and_size(group) -> tuple[int, int]:
    """(this process's rank in `group`, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad an array along `axis` to a multiple (fixed-shape sharding)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad, constant_values=fill)
