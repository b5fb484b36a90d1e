"""Batched multi-sequence SLAM (BASELINE.json config #3; port of
visual_slam_tpu/multi.py:40-100).

B sequences run in lockstep: one batched front-end call a step, with one
launch of kernel B1 and one of B3 for all B images, then each sequence's
Slam consumes its slice of the batch (`Slam.consume`, as `process` does). The reference is strictly
single-sequence (SURVEY.md §2.3), so the semantics are "B independent
reference pipelines" sharing a front-end: each sequence's Slam gets the
same features, and so the same history, as its own `run_sequence`.

Distinct pseudo-sequences for tests and demos come from
utils.dataset.WindowView (offset, strided or reversed windows over a base
sequence).
"""
from __future__ import annotations

import numpy as np
import torch

from .config import SlamConfig
from .models import frontend
from .pipeline import Slam


def run_batched(sequences: list, config: SlamConfig | None = None, start: int = 0,
                stop: int | None = None, device="cuda") -> list[Slam]:
    """Run SLAM over B sequences with a shared, batched front-end.

    Args:
      sequences: objects with the reader's `__len__`, `gray(i)` and
        `depth(i)` (utils.dataset.ICLNUIMDataset, WindowView, or
        utils.scene.SyntheticRGBDScene / FrameSequence).
      config: shared by every sequence's Slam (default: SlamConfig()).
      start/stop: frame range applied to every sequence; the run stops at
        the end of the shortest.
    Returns:
      one Slam per sequence; each records stats["frontend_devices"] = 1,
      the number of cards its front-end ran on.

    The JAX function's `mesh` (the batch sharded over a device mesh) waits
    for the multi-card solvers; its `use_depth_list` is accepted there and
    never read, and is left out here.
    """
    cfg = config or SlamConfig()
    slams = [Slam(cfg, device=device) for _ in sequences]
    n = min((stop if stop is not None else len(ds)) - start for ds in sequences)
    for step in range(n):
        i = start + step
        grays = torch.from_numpy(np.stack([ds.gray(i) for ds in sequences]))
        feats = frontend.extract_batch(
            grays.to(slams[0].device), cfg.frontend.max_features,
            cfg.frontend.quality_level, cfg.frontend.nms_radius,
        )
        for b, slam in enumerate(slams):
            fb = frontend.Features(*(a[b] for a in feats))
            slam.consume(i, fb, sequences[b].depth(i) if cfg.use_depth else None)
    for slam in slams:
        slam.stats["frontend_devices"] = 1
    return slams
