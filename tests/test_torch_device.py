"""The port's entry points run on the card unless the caller names another
device: without a card, a call that names none raises instead of running on
the CPU. The test decides inside itself whether a card is present."""
import numpy as np
import pytest
import torch

from torch_parity import ICL_INTR

from visual_slam_tpu_torch import entry, multi
from visual_slam_tpu_torch.config import MapConfig, SlamConfig
from visual_slam_tpu_torch.models import ba, frontend
from visual_slam_tpu_torch.models.map_state import SlamMap
from visual_slam_tpu_torch.pipeline import Slam, run_sequence
from visual_slam_tpu_torch.utils import synthetic
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene


def _small_problem_args():
    rng = np.random.default_rng(0)
    K, O, P = 3, 60, 20
    return dict(R=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
                t=rng.normal(size=(K, 3)).astype(np.float32),
                X=rng.normal(size=(P, 3)).astype(np.float32),
                cam=rng.integers(0, K, O).astype(np.int32),
                pnt=rng.integers(0, P, O).astype(np.int32),
                uv=rng.uniform(0, 600, (O, 2)).astype(np.float32),
                w=np.ones(O, np.float32), intr=ICL_INTR, cam_fixed=np.arange(K) == 0)


ENTRY_POINTS = {
    "Slam": lambda: Slam(SlamConfig(use_depth=True)),
    "run_sequence": lambda: run_sequence(SyntheticRGBDScene(2, 48, 64), SlamConfig(use_depth=True)),
    "run_sequence_pipelined": lambda: run_sequence(SyntheticRGBDScene(2, 48, 64),
                                                   SlamConfig(use_depth=True), pipelined=True),
    "make_problem": lambda: ba.make_problem(**_small_problem_args()),
    "to_ba_problem": lambda: SlamMap(MapConfig()).to_ba_problem(ICL_INTR),
    "build_loop_map": lambda: synthetic.build_loop_map(16, 64, 4),
    "arc_problem": lambda: synthetic.arc_problem(3, 20),
    "extract_batch": lambda: frontend.extract_batch(np.zeros((2, 48, 64), np.float32)),
    "run_batched": lambda: multi.run_batched([SyntheticRGBDScene(2, 48, 64)] * 2,
                                             SlamConfig(use_depth=True)),
    "entry": lambda: entry.entry(),
    "dryrun_multichip": lambda: entry.dryrun_multichip(1),
    "dryrun_multihost": lambda: entry.dryrun_multihost(),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
        ENTRY_POINTS[name]()

