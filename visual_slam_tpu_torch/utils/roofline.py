"""Hand-counted per-stage operations and bytes of the tracking path, against
the H100's peaks (port of visual_slam_tpu/utils/roofline.py).

The counts describe the work of each stage and hold on any chip; only the
peaks are the card's. Each numerator is derived from the stage's shapes and
defended next to its term. `tracking_stages` gives each stage of one
tracked frame as a callable; the benchmark (`bench.py`, its roofline
section) and chip_smoke.py (phase 25) time them on the card and print
`stage_table` on those times.

Conventions: a fused multiply-add counts as 2 operations; a compare or max
as 1. "bytes" is the stage's traffic ASSUMING its operands and results
round-trip device memory: operands read once, results written once. A stage
measured faster than that allows (implied GB/s above the HBM peak) disproves
the assumption: its arrays stayed in shared memory or L2. `stage_table`
marks such a row `hbm_roundtrip: False`, drops its bandwidth share and
classifies it by operations alone: no row reports more than 100% of a peak.
"""
from __future__ import annotations

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# power limit. Float32 is the rate outside the tensor cores: the port turns
# TF32 off (visual_slam_tpu_torch/__init__.py), so its float32 products run
# on the CUDA cores.
PEAK_BF16_TFLOPS = 989.0
PEAK_F32_TFLOPS = 67.0
PEAK_HBM_GBPS = 3350.0


def stage_costs(
    H: int = 480,
    W: int = 640,
    K: int = 1024,   # feature budget (frontend max_features)
    M: int = 2048,   # tracking-snapshot capacity (map.track_capacity)
    B: int = 32,     # descriptor rotation bins (descriptor_mxu.N_BINS)
    D: int = 256,    # descriptor bits
    PATCH: int = 32,
    nms_radius: int = 3,
    blur_radius: int = 4,
    gn_iters: int = 10,
) -> dict:
    """Per-stage dicts: {flops, flops_dtype, bytes, note}."""
    px = H * W
    s = {}

    # -- detect_blur (kernel B1, csrc/detect_blur.cu) --
    # Per pixel: Sobel ix,iy (5 add + 1 mul each = 12); 3 gradient products;
    # 3 separable 3x3 box sums (4 adds each) + 3 scale muls = 15; min-eig
    # response ~8 (incl. sqrt); border mask 1; separable NMS radius r =
    # 2*(2r) maxes + 1 compare = 13 at r=3; separable Gaussian blur radius 4
    # = 2*(1 + 4*3) = 26.  Total ~78 float32 operations a pixel.
    nms = 4 * nms_radius + 1
    blur = 2 * (1 + blur_radius * 3)
    per_px = 12 + 3 + 15 + 8 + 1 + nms + blur
    s["detect_blur"] = dict(
        flops=per_px * px, flops_dtype="f32",
        bytes=4 * px + 2 * 4 * px,  # image in, peaks + blurred out
        note=f"{per_px} flops/px x {px} px; 1 read + 2 writes",
    )

    # -- top-k corner select (frontend._topk_select, a stable sort over H*W) --
    # Counted as one comparison sweep of the peak map: a lower bound of any
    # exact top-k, the sort's included.
    s["topk"] = dict(
        flops=px, flops_dtype="f32",
        bytes=4 * px + K * 8,
        note="1 compare/px lower bound; peak map read, K (uv,score) out",
    )

    # -- patches (kernel B3, csrc/patch.cu): the 32x32 patch of the blurred
    # image at each keypoint, a copy. The JAX package's aligned-window copy
    # and one-hot cut (its `windows` and `cut_patches` rows) are one launch
    # here, so only the function's bytes count: the image and uv read, the
    # patches written.
    s["patches"] = dict(
        flops=0, flops_dtype="-",
        bytes=4 * px + K * 2 * 4 + K * PATCH * PATCH * 4,
        note="pure copy: image and uv read, K 32x32 float32 patches written",
    )

    # -- orientation moments (descriptor_mxu.orientation_from_patches) --
    s["orientation"] = dict(
        flops=2 * 2 * K * PATCH * PATCH, flops_dtype="f32",
        bytes=K * PATCH * PATCH * 4,
        note="two K x 1024 matvecs (m10, m01)",
    )

    # -- descriptor sampling (descriptor_mxu._sample_and_pack) --
    # All-bin difference product kp,bpd->bkd: 2*K*PATCH^2*D*B, then the
    # one-hot bin blend bkd,kb->kd: 2*B*K*D. The product's inputs are
    # rounded to bf16 but held and multiplied in float32 (TF32 off), so the
    # operands are 4 bytes and the rate is float32's.
    samp = 2 * K * PATCH * PATCH * D * B
    s["descriptor"] = dict(
        flops=samp + 2 * B * K * D, flops_dtype="f32",
        bytes=(
            K * PATCH * PATCH * 4        # flat patches
            + B * PATCH * PATCH * D * 4  # difference matrices
            + 2 * B * K * D * 4          # (B,K,D) f32 intermediate w+r
            + K * 8 * 4                  # packed descriptors out
        ),
        note=f"2*{K}*{PATCH**2}*{D}*{B} float32 MACs on bf16-rounded inputs; "
        "the (B,K,D) intermediate round-trips HBM",
    )

    # -- matching (ops/match.match_ratio_test) --
    # +/-1 Gram product 2*M*K*D in float32 (every value a small integer,
    # exact); top-2 + mutual check ~3 compares a cell.
    s["match"] = dict(
        flops=2 * M * K * D + 3 * M * K, flops_dtype="f32",
        bytes=(M + K) * D // 8 + (M + K) * D * 4 + M * K * 4,
        note="Hamming-as-matmul (M x 256)(256 x K) on float32 +/-1 expansions; "
        "distance matrix written once for top-2/mutual passes",
    )

    # -- PnP fast path (ops/pnp.refine_from_prior, solve_pnp_tracked's
    # prior-seeded branch) --
    # 3 residual sweeps (project + gate, ~20 flops/pt) + 2 GN calls x
    # gn_iters x ~120 flops/pt (27 upper-H products + J rows + residual).
    s["pnp"] = dict(
        flops=3 * 20 * M + 2 * gn_iters * 120 * M, flops_dtype="f32",
        bytes=M * (3 + 2 + 1) * 4 * 3,
        note="residual sweeps + 2 Huber-IRLS GN refines (RANSAC branch "
        "excluded: not taken with a frame-rate prior)",
    )

    s["_total"] = dict(flops=sum(v["flops"] for v in s.values()),
                       bytes=sum(v["bytes"] for v in s.values()))
    return s


def stage_table(costs: dict, measured_ms: dict | None = None) -> dict:
    """Roofline table: per-stage flops/bytes (+ achieved rates and % of
    peak when measured times are supplied).

    measured_ms keys must match stage_costs keys; stages without a
    measurement get no rates.
    """
    table = {}
    for k, v in costs.items():
        if k.startswith("_"):
            continue
        row = dict(
            gflops=round(v["flops"] / 1e9, 4),
            mbytes=round(v["bytes"] / 1e6, 2),
            dtype=v["flops_dtype"],
            note=v["note"],
        )
        ms = (measured_ms or {}).get(k)
        if ms:
            peak = PEAK_BF16_TFLOPS if v["flops_dtype"] == "bf16" else PEAK_F32_TFLOPS
            row["ms"] = round(ms, 4)
            pct_compute = v["flops"] / ms / 1e9 / peak * 100
            implied_gbps = v["bytes"] / ms / 1e6
            pct_hbm = implied_gbps / PEAK_HBM_GBPS * 100
            # Physics check: implied bandwidth above the HBM peak means the
            # modeled round trip did not happen (the arrays stayed in shared
            # memory or L2), so the byte model says nothing about this
            # stage's bound: classify by operations alone. Likewise above
            # 100% of the operation peak the count overcounts: the row is
            # flagged and no number derived from it is printed.
            row["hbm_roundtrip"] = implied_gbps <= PEAK_HBM_GBPS
            if row["hbm_roundtrip"]:
                row["achieved_gbps"] = round(implied_gbps, 1)
                row["pct_hbm_peak"] = round(pct_hbm, 2)
            else:
                row["achieved_gbps"] = None
                row["pct_hbm_peak"] = None
            flops_ok = pct_compute <= 100.0
            if flops_ok:
                row["achieved_tflops"] = round(v["flops"] / ms / 1e9, 3)
                row["pct_compute_peak"] = round(pct_compute, 2)
            else:
                row["achieved_tflops"] = None
                row["pct_compute_peak"] = None
                row["flop_model_overcounts"] = True
            if not flops_ok:
                row["bound"] = "unknown (flop model overcounts this stage)"
            elif not row["hbm_roundtrip"]:
                row["bound"] = "compute (fused: modeled bytes stayed in shared memory or L2)"
            elif pct_compute >= pct_hbm:
                row["bound"] = "compute"
            else:
                row["bound"] = "bandwidth"
        table[k] = row
    return table


def tracking_stages(device, gray, K: int = 1024, M: int = 2048, intrinsics=None,
                    seed: int = 25, refine_iters: int = 10, n_hyps: int = 128) -> dict:
    """Each stage of one tracked frame as a callable on `device` tensors: the
    tracking path's own functions in order, each on the outputs of the one
    before, over `gray` ((H,W) gray, uint8 or float); matching against an
    M-slot snapshot of random descriptors; PnP's prior-seeded branch
    (pnp.refine_from_prior: no host read) on M points seen from a pose 3 cm
    and ~1 deg off the prior; and, as "pnp_ransac_branch", the tracked
    solver from a prior 40 deg / 40 deg off (the JAX bench's, bench.py:
    406-419), which falls through to RANSAC. Every row but the last has a
    `stage_costs` row of the same name. `seed` draws the snapshot, the
    points' noise and the RANSAC minimal sets."""
    from scipy.spatial.transform import Rotation

    from ..models import frontend
    from ..ops import descriptor_mxu, lie, match, pnp, projection
    from ..ops.kernels import detect_kernel, patch_kernel
    from .scene import ICL_INTRINSICS

    rng = np.random.default_rng(seed)
    gray = frontend.to_gray(torch.as_tensor(np.asarray(gray)).to(device))
    peaks, blurred = detect_kernel.corner_peaks_and_blur(gray)
    uv, _, valid = frontend._topk_select(peaks, K)
    flat = patch_kernel.extract_patches(blurred, uv).reshape(K, -1)
    theta = descriptor_mxu.orientation_from_patches(flat)
    desc = descriptor_mxu._sample_and_pack(flat, theta)
    snap_desc = torch.from_numpy(rng.integers(0, 2**32, (M, 8), dtype=np.uint32).view(np.int32)).to(device)
    snap_valid = torch.ones(M, dtype=torch.bool, device=device)
    X = torch.from_numpy(np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M),
                                   rng.uniform(2, 8, M)], -1).astype(np.float32)).to(device)
    intr = torch.tensor(ICL_INTRINSICS if intrinsics is None else intrinsics, dtype=torch.float32,
                        device=device)
    R = lie.so3_exp(torch.tensor([0.01, -0.02, 0.005], device=device))
    t = torch.tensor([0.03, -0.01, 0.02], device=device)
    obs = projection.project(R, t, X, intr)[0] + torch.from_numpy(
        rng.normal(scale=0.5, size=(M, 2)).astype(np.float32)).to(device)
    eye, zero = torch.eye(3, device=device), torch.zeros(3, device=device)
    R_bad = torch.tensor(Rotation.from_euler("xyz", [40, 40, 0], degrees=True).as_matrix(),
                         dtype=torch.float32, device=device)
    t_bad = torch.ones(3, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {
        "detect_blur": lambda: detect_kernel.corner_peaks_and_blur(gray),
        "topk": lambda: frontend._topk_select(peaks, K),
        "patches": lambda: patch_kernel.extract_patches(blurred, uv),
        "orientation": lambda: descriptor_mxu.orientation_from_patches(flat),
        "descriptor": lambda: descriptor_mxu._sample_and_pack(flat, theta),
        "match": lambda: match.match_ratio_test(snap_desc, desc, snap_valid, valid),
        "pnp": lambda: pnp.refine_from_prior(X, obs, intr, snap_valid, eye, zero,
                                             refine_iters=refine_iters),
        "pnp_ransac_branch": lambda: pnp.solve_pnp_tracked(
            X, obs, intr, snap_valid, R_bad, t_bad, generator=gen, n_hyps=n_hyps,
            refine_iters=refine_iters),
    }
