"""The port's roofline (visual_slam_tpu_torch/utils/roofline.py) against the
JAX package's: the same counts of the work wherever the port's stage does
the same work, only the peaks the H100's, and the table's guards. Counts
are integers and compare exactly."""
import pytest

from visual_slam_tpu.utils import roofline as jroofline

from visual_slam_tpu_torch.utils import roofline

# Stages whose work and operand dtypes are the JAX package's: every count
# equal. The descriptor's and matcher's products run on float32 operands in
# the port (bf16-rounded inputs, TF32 off), so their operations are JAX's
# and their bytes are recounted.
SAME = ("detect_blur", "topk", "orientation", "pnp")
SAME_FLOPS = ("descriptor", "match")
SHAPES = [dict(), dict(H=240, W=320, K=256, M=512), dict(K=2048, M=4096, gn_iters=5)]


@pytest.mark.parametrize("shape", SHAPES, ids=["default", "half", "wide"])
def test_stage_costs_match_jax(shape):
    ours, theirs = roofline.stage_costs(**shape), jroofline.stage_costs(**shape)
    assert set(ours) == (set(theirs) - {"windows", "cut_patches"}) | {"patches"}
    for k in SAME:
        assert ours[k]["flops"] == theirs[k]["flops"] and ours[k]["bytes"] == theirs[k]["bytes"], k
        assert ours[k]["flops_dtype"] == theirs[k]["flops_dtype"] == "f32", k
    for k in SAME_FLOPS:
        assert ours[k]["flops"] == theirs[k]["flops"] and ours[k]["flops_dtype"] == "f32", k
    H, W, K, M = (shape.get(x, d) for x, d in (("H", 480), ("W", 640), ("K", 1024), ("M", 2048)))
    # The bf16 operands JAX counts at 2 bytes are float32 here.
    assert ours["descriptor"]["bytes"] == theirs["descriptor"]["bytes"] + K * 32 * 32 * 2 + 32 * 32 * 32 * 256 * 2
    assert ours["match"]["bytes"] == theirs["match"]["bytes"] + (M + K) * 256 * 2


def test_patches_is_b3s_bound_bytes():
    """The patches row counts what kernel B3 must move (chip_smoke.py's B3
    bound): the frame and uv read, K 32x32 float32 patches written; 5.4 MB
    at 640x480, K=1024."""
    H, W, K = 480, 640, 1024
    row = roofline.stage_costs(H=H, W=W, K=K)["patches"]
    assert row["flops"] == 0 and row["bytes"] == 4 * (H * W + 2 * K + 32 * 32 * K)
    assert round(row["bytes"] / 1e6, 1) == 5.4


def test_peaks_are_the_h100s():
    assert (roofline.PEAK_BF16_TFLOPS, roofline.PEAK_F32_TFLOPS, roofline.PEAK_HBM_GBPS) == (
        989.0, 67.0, 3350.0)


def test_stage_table_guards():
    """On synthetic times: a stage faster than the HBM peak allows reads
    hbm_roundtrip False and no bandwidth share; one faster than the
    operation peak allows reads no operation share; no row states more
    than 100% of a peak; an untimed stage gets no rates."""
    costs = roofline.stage_costs()
    at_peak_hbm = {k: v["bytes"] / (roofline.PEAK_HBM_GBPS * 1e6) for k, v in costs.items()
                   if not k.startswith("_")}
    ms = {"detect_blur": at_peak_hbm["detect_blur"] / 2,   # twice the HBM peak
          "descriptor": costs["descriptor"]["flops"] / (roofline.PEAK_F32_TFLOPS * 1e9) / 2,
          "match": 10.0, "patches": at_peak_hbm["patches"] * 4}
    table = roofline.stage_table(costs, ms)
    det = table["detect_blur"]
    assert det["hbm_roundtrip"] is False and det["pct_hbm_peak"] is None and det["achieved_gbps"] is None
    assert det["bound"].startswith("compute (fused")
    desc = table["descriptor"]
    assert desc["pct_compute_peak"] is None and desc["achieved_tflops"] is None
    assert desc["flop_model_overcounts"] and desc["bound"].startswith("unknown")
    assert table["match"]["bound"] == "compute" and table["patches"]["bound"] == "bandwidth"
    assert table["patches"]["pct_hbm_peak"] == 25.0
    for row in table.values():
        for key in ("pct_hbm_peak", "pct_compute_peak"):
            assert row.get(key) is None or row[key] <= 100.0
    assert "ms" not in table["pnp"] and "bound" not in table["pnp"]
