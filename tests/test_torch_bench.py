"""The port's benchmark (visual_slam_tpu_torch/bench.py) on the CPU at the
half size (320x240: halved intrinsics, K=256, M=512), 24 frames, its
headline and rgbd sections: the output contract, the verdict against the
record's own fields, every device number "not measured", and each run's
history and camera centres bit-equal to pipeline.run_sequence over the
same frames (the parity tests hold run_sequence against the JAX package).
Also the roofline section's rows on the CPU, the exit without a card, and
the scene-length guard, and the reader's native loader at the half size.
One torch thread (tests/torch_parity.py)."""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch intra-op thread)

from visual_slam_tpu.utils import roofline as jroofline

from visual_slam_tpu_torch import bench, native
from visual_slam_tpu_torch.config import SlamConfig
from visual_slam_tpu_torch.pipeline import run_sequence
from visual_slam_tpu_torch.utils import dataset, roofline
from visual_slam_tpu_torch.utils.scene import SyntheticRGBDScene

H, W, FRAMES = 240, 320, 24
SMALL = ["--device", "cpu", "--height", str(H), "--width", str(W)]
ARGS = SMALL + ["--frames", str(FRAMES), "--fullseq-frames", "0", "--sections", "headline,rgbd"]
SUMMARY_KEYS = ("metric", "value", "unit", "fps_io_passes", "fps_no_io", "fps_device_rate",
                "ate_rmse_m", "tracking_phase_fps", "init_phase_s", "mode", "keyframes", "correct",
                "device")


def _main(argv, keep=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv, keep=keep)
    return rc, out.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def small_run():
    keep = {}
    rc, lines = _main(ARGS, keep)
    return rc, lines, keep


def test_output_contract(small_run):
    """A partial headline after the headline section, the full record on the
    line before the last, the compact headline last; exit 0 exactly when
    the record is correct."""
    rc, lines, _ = small_run
    assert len(lines) == 3
    partial, rec, head = (json.loads(x) for x in lines)
    assert partial["partial"] is True and partial["value"] == head["value"]
    assert all(k in head for k in SUMMARY_KEYS) and "partial" not in head
    assert head["unit"] == "frames/s" and head["mode"] == "serial"
    assert isinstance(rec["correct"], bool) and head["correct"] is rec["correct"]
    assert rc == (0 if rec["correct"] else 1)
    h = rec["sections"]["headline"]
    assert head["value"] == h["fps_io"] == max(h["fps_io_passes"]) and len(h["fps_io_passes"]) == 2
    assert head["fps_no_io"] == h["fps_no_io"] == max(h["fps_no_io_passes"])
    assert list(rec["sections"]) == ["headline", "rgbd"]
    assert rec["vs_baseline"] is None and rec["vs_baseline_reason"]
    assert set(rec["kernels"]) == {"detect_blur", "patch", "cam_reduce", "cam_expand"}
    assert all(k["source"].startswith("visual_slam_tpu_torch/csrc/") for k in rec["kernels"].values())


def test_correct_agrees_with_fields(small_run):
    """`correct` is what the record's own ATE and failure fields say."""
    _, lines, _ = small_run
    rec = json.loads(lines[-2])

    def ok(run):
        return run["ate_rmse_m"] is not None and run["ate_rmse_m"] < bench.ATE_LIMIT_M \
            and run["track_failures"] == 0

    s = rec["sections"]
    want = {"headline_sim3": ok(s["headline"]["io"]) and ok(s["headline"]["no_io"]),
            "rgbd_se3": ok(s["rgbd"]["io"]) and ok(s["rgbd"]["no_io"])}
    assert rec["checks"] == want and rec["correct"] == all(want.values())
    # The RGB-D loop initialises at its first frame and tracks all 24 here.
    assert want["rgbd_se3"] and s["rgbd"]["io"]["history"]["init"] == 0


def test_device_numbers_not_measured(small_run):
    """On the CPU no number stands under a device metric's name, and no
    kernel launches."""
    _, lines, _ = small_run
    rec, head = json.loads(lines[-2]), json.loads(lines[-1])
    assert rec["device"] == head["device"] == {"platform": "cpu", "kind": "cpu", "count": 0,
                                               "smi": bench.NOT_MEASURED}
    for name in ("headline", "rgbd"):
        sec = rec["sections"][name]
        for run in (sec["io"], sec["no_io"], sec["other_driver"]):
            assert run["peak_mem_gb"] == bench.NOT_MEASURED
            assert set(run["launches"].values()) == {0}
    assert "build_s" not in rec


@pytest.mark.parametrize("name", ["headline", "rgbd"])
def test_runs_equal_run_sequence(small_run, name):
    """The bench's frames are the scene's, as decoded from its ICL-NUIM
    directory; over them, its runs (both drivers) are run_sequence's, bit
    for bit, and its record reports their history and ATE."""
    _, lines, keep = small_run
    rec = json.loads(lines[-2])["sections"][name]
    frames = keep[f"{name}_frames"]
    intr = bench.ICL_INTRINSICS / 2
    scene = SyntheticRGBDScene(FRAMES, H, W, intr, seed=0)
    assert len(frames) == FRAMES
    for (i, gray, depth), (j, g0, d0) in zip(frames.frames(), scene.frames()):
        g = gray / 255.0 if gray.dtype == np.uint8 else gray
        assert i == j and np.abs(g - g0).max() <= 0.5 / 255 + 1e-6
        assert np.abs(depth - d0).max() <= 0.5 / 5000 + 1e-6
    cfg = SlamConfig(intrinsics=intr, use_depth=name == "rgbd")
    cfg.frontend.max_features, cfg.map.track_capacity = 256, 512
    for driver, slam in (("serial", keep[name]), ("pipelined", keep[f"{name}_other"])):
        ref = run_sequence(frames, cfg, device="cpu", pipelined=driver == "pipelined")
        assert bench.same_run(slam, ref), driver
        idxs, centres = slam.positions()
        ridxs, rcentres = ref.positions()
        assert np.array_equal(idxs, ridxs) and np.array_equal(centres, rcentres)
        run = rec["no_io"] if driver == "serial" else rec["other_driver"]
        assert run["driver"] == driver and run["history"]["init"] == ref.stats["init_frame"]
        assert run["history"]["keyframes"] == [f.frame_idx for f in ref.trajectory if f.is_keyframe]
        assert run["keyframes"] == ref.stats["keyframes"] and run["ba_runs"] == ref.stats["ba_runs"]
        assert run["ate_rmse_m"] == bench.ate(ref, frames.ground_truth(), align_scale=name == "headline")
    assert rec["passes_bit_equal"]
    assert rec["io"]["history"] == rec["no_io"]["history"]


def test_roofline_rows_on_cpu():
    """The roofline section on the CPU runs every stage once and gives
    stage_costs' rows at the half size (the JAX package's counts where the
    work is the same, tests/test_torch_roofline.py), every time "not
    measured"."""
    rc, lines = _main(SMALL + ["--frames", "2", "--sections", "roofline"])
    assert rc == 0
    roof = json.loads(lines[-2])["sections"]["roofline"]
    costs = roofline.stage_costs(H=H, W=W, K=256, M=512)
    want = roofline.stage_table(costs)
    assert set(roof["table"]) == set(want)
    theirs = jroofline.stage_costs(H=H, W=W, K=256, M=512)
    for k, row in roof["table"].items():
        assert row["ms"] == row["kernel_ms"] == bench.NOT_MEASURED
        assert {c: row[c] for c in ("gflops", "mbytes", "dtype", "note")} == \
            {c: want[k][c] for c in ("gflops", "mbytes", "dtype", "note")}
        assert "pct_hbm_peak" not in row and "pct_compute_peak" not in row
        if k in ("detect_blur", "topk", "orientation", "pnp", "descriptor", "match"):
            assert row["gflops"] == round(theirs[k]["flops"] / 1e9, 4)
    assert roof["pnp_ransac_branch_ms"] == bench.NOT_MEASURED and roof["ransac_branch_took_ransac"]
    assert set(roof["launches"].values()) == {0}
    assert json.loads(lines[-1])["roofline_ms"] == {k: bench.NOT_MEASURED for k in want}


def test_no_card_exits_1(monkeypatch, capsys):
    """Without a card and without --device cpu the bench prints why and
    exits 1, with nothing on stdout; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--frames", "24", "--sections", "headline"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA card" in out.err


def test_scene_length_guard(capsys):
    """The synthetic scene's default trajectory leaves the room past 280
    frames: the bench refuses more without --data."""
    with pytest.raises(SystemExit) as e:
        bench.parse_args(["--frames", str(bench.MAX_SCENE_FRAMES + 1)])
    assert e.value.code == 2 and "leaves the room" in capsys.readouterr().err
    assert bench.parse_args(["--frames", "280", "--sections", "rgbd,headline"]).sections == ["headline", "rgbd"]


def test_reader_frames_at_the_directorys_size(tmp_path):
    """The headline's io pass reads its directory with
    ICLNUIMDataset.frames: where the native loader builds, it decodes at the
    size of the first image's header (here 64x48, not 640x480), uint8 gray
    equal to the PIL path's up to its rounding, the reader's depth."""
    if not native.available():
        pytest.skip(f"the native loader does not build here: {native.build_error}")
    scene = SyntheticRGBDScene(3, 48, 64)
    ds = dataset.ICLNUIMDataset(dataset.write_icl_nuim(str(tmp_path), scene.frames(), scene.ground_truth()))
    got = list(ds.frames())
    assert [i for i, _, _ in got] == [0, 1, 2]
    for i, g8, d in got:
        assert g8.dtype == np.uint8 and g8.shape == (48, 64) and np.array_equal(d, ds.depth(i))
        assert np.abs(g8.astype(np.float32) / 255.0 - ds.gray(i)).max() < 1.5 / 255.0
