"""Batched multi-sequence SLAM (BASELINE.json config #3; port of
visual_slam_tpu/multi.py:40-100).

B sequences run in lockstep: one batched front-end call a step, with one
launch of kernel B1 and one of B3 for all B images (for each device's
sub-stack when the batch is split over `devices`), then each sequence's
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
                stop: int | None = None, device="cuda", devices: list | None = None) -> list[Slam]:
    """Run SLAM over B sequences with a shared, batched front-end.

    Args:
      sequences: objects with the reader's `__len__`, `gray(i)` and
        `depth(i)` (utils.dataset.ICLNUIMDataset, WindowView, or
        utils.scene.SyntheticRGBDScene / FrameSequence).
      config: shared by every sequence's Slam (default: SlamConfig()).
      start/stop: frame range applied to every sequence; the run stops at
        the end of the shortest.
      device: where everything runs when `devices` is None.
      devices: the JAX function's `mesh`: a list of D devices the batch is
        split over. The stack is padded to a multiple of D (with its own
        first frames) and cut into D contiguous sub-stacks, one B1 and one
        B3 launch for each a step; sequence b's Slam runs on the device of
        its sub-stack.
    Returns:
      one Slam per sequence; each records stats["frontend_devices"], the
      number of devices the front-end ran on (1 without `devices`, else D).

    The JAX function's `use_depth_list` is accepted there and never read,
    and is left out here.
    """
    cfg = config or SlamConfig()
    B = len(sequences)
    devs = [torch.device(d) for d in (devices if devices else [device])]
    pad = (-B) % len(devs)
    per = (B + pad) // len(devs)
    slams = [Slam(cfg, device=devs[b // per]) for b in range(B)]
    n = min((stop if stop is not None else len(ds)) - start for ds in sequences)
    for step in range(n):
        i = start + step
        grays = np.stack([ds.gray(i) for ds in sequences])
        if pad:
            grays = np.concatenate([grays, grays[:pad]])
        grays = torch.from_numpy(grays)
        for d, dev in enumerate(devs):
            feats = frontend.extract_batch(
                grays[d * per:(d + 1) * per].to(dev), cfg.frontend.max_features,
                cfg.frontend.quality_level, cfg.frontend.nms_radius,
            )
            for k in range(min(per, B - d * per)):
                b = d * per + k
                fb = frontend.Features(*(a[k] for a in feats))
                slams[b].consume(i, fb, sequences[b].depth(i) if cfg.use_depth else None)
    for slam in slams:
        slam.stats["frontend_devices"] = len(devs)
    return slams
