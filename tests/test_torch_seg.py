"""Kernels B4/B5 (camera-segment reduce and expand) of visual_slam_tpu_torch:
their plain PyTorch versions against the JAX package's Pallas kernels run in
interpret mode on the CPU, the out-of-range rule, the wrappers' device rule,
and the scale-edge terms of ops/lie beside them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import cam_reduce_walk, exact_reduce, n, run_cameras, t

from visual_slam_tpu.ops import lie as jlie
from visual_slam_tpu.ops.pallas import seg_kernel as jseg

from visual_slam_tpu_torch.ops import lie
from visual_slam_tpu_torch.ops.kernels import seg_kernel

# The JAX package's own bar between its reduce kernel and its XLA version
# (tests/test_pallas_kernels.py:46-48): f32 sums associate differently.
REDUCE_RTOL, REDUCE_ATOL = 1e-5, 1e-4
SCALE_EDGE_ATOL = 1e-6


def _inputs(C, N, K, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(C, N)).astype(np.float32)
    cam = rng.integers(0, K, N).astype(np.int32)
    x = rng.normal(size=(C, K)).astype(np.float32)
    return data, cam, x


@pytest.mark.parametrize("C,N,K", [(8, 5000, 300), (27, 4096, 257)])
def test_plain_matches_pallas(C, N, K):
    data, cam, x = _inputs(C, N, K)
    want_red = jseg.cam_reduce(jnp.asarray(data), jnp.asarray(cam), K, interpret=True)
    want_exp = jseg.cam_expand(jnp.asarray(x), jnp.asarray(cam), interpret=True)
    red = seg_kernel.cam_reduce_torch(t(data), t(cam), K)
    np.testing.assert_allclose(n(red), np.asarray(want_red), rtol=REDUCE_RTOL, atol=REDUCE_ATOL)
    np.testing.assert_array_equal(n(seg_kernel.cam_expand_torch(t(x), t(cam))), np.asarray(want_exp))


def test_out_of_range_cameras():
    """A slot whose camera is outside [0,K) adds nothing and receives 0, as
    the Pallas kernels' padding rule gives (ids K..H*128-1, >= H*128, < 0)."""
    C, N, K = 5, 3001, 257
    data, cam, x = _inputs(C, N, K, seed=1)
    cam[::7] = K + 3  # inside the Pallas kernels' padded camera range
    cam[::11] = 5000  # beyond it
    cam[::13] = -1
    bad = (cam < 0) | (cam >= K)
    want_red = jseg.cam_reduce(jnp.asarray(data), jnp.asarray(cam), K, interpret=True)
    want_exp = jseg.cam_expand(jnp.asarray(x), jnp.asarray(cam), interpret=True)
    red = n(seg_kernel.cam_reduce_torch(t(data), t(cam), K))
    exp = n(seg_kernel.cam_expand_torch(t(x), t(cam)))
    np.testing.assert_allclose(red, np.asarray(want_red), rtol=REDUCE_RTOL, atol=REDUCE_ATOL)
    np.testing.assert_array_equal(exp, np.asarray(want_exp))
    assert not exp[:, bad].any()
    ref = np.zeros((C, K), np.float32)
    np.add.at(ref.T, cam[~bad], data[:, ~bad].T)
    np.testing.assert_allclose(red, ref, rtol=REDUCE_RTOL, atol=REDUCE_ATOL)


def test_wrappers_use_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    data, cam, x = _inputs(6, 1000, 40, seed=2)
    counts = seg_kernel.reduce_launches, seg_kernel.expand_launches
    assert torch.equal(seg_kernel.cam_reduce(t(data), t(cam), 40),
                       seg_kernel.cam_reduce_torch(t(data), t(cam), 40))
    assert torch.equal(seg_kernel.cam_expand(t(x), t(cam)), seg_kernel.cam_expand_torch(t(x), t(cam)))
    assert (seg_kernel.reduce_launches, seg_kernel.expand_launches) == counts


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor neither on the CPU nor on a CUDA card raises: no fallback."""
    data = torch.zeros((3, 10), device="meta")
    cam = torch.zeros(10, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        seg_kernel.cam_reduce(data, cam, 4)
    with pytest.raises(ValueError):
        seg_kernel.cam_expand(torch.zeros((3, 4), device="meta"), cam)


def test_scale_edge_terms_match_jax():
    rng = np.random.default_rng(3)
    K, E = 7, 9
    w = rng.normal(scale=0.3, size=(K, 3)).astype(np.float32)
    R = np.asarray(jax.vmap(jlie.so3_exp)(jnp.asarray(w)))
    tr = rng.normal(size=(K, 3)).astype(np.float32)
    i = rng.integers(0, K, E).astype(np.int32)
    j = (i + 1 + rng.integers(0, K - 1, E)).astype(np.int32) % K
    meas = rng.uniform(0.1, 2.0, E).astype(np.float32)
    want = jlie.scale_edge_terms(jnp.asarray(R), jnp.asarray(tr), jnp.asarray(i),
                                 jnp.asarray(j), jnp.asarray(meas))
    got = lie.scale_edge_terms(t(R), t(tr), t(i), t(j), t(meas))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w_), rtol=0, atol=SCALE_EDGE_ATOL)


# ---------------------------------------------------------------------------
# B4's reduce plan and the kernel's order of additions (`cam_reduce_walk`,
# tests/torch_parity.py).

def _plan_case(case, seed=5):
    """(cam (N,) int32, K, tile) for the shapes B4 meets. "kfba": the
    keyframe BA's padding pattern, make_problem's Q=8 slots per landmark with
    one real observation each and the padding slots on camera 0 (87% of the
    slots on camera 0 in all)."""
    rng = np.random.default_rng(seed)
    if case == "ragged":  # ids >= K and < 0; N a multiple of no tile
        N, K, tile = 3001, 257, 256
        cam = rng.integers(0, K, N).astype(np.int32)
        cam[::7], cam[::11], cam[::13] = K + 3, 5000, -1
    elif case == "hot":  # 90% of the slots on 3 cameras
        N, K, tile = 8192, 300, 1024
        cam = rng.integers(0, K, N).astype(np.int32)
        hot = rng.uniform(size=N) < 0.9
        cam[hot] = np.array([7, 123, K - 1], np.int32)[rng.integers(0, 3, int(hot.sum()))]
    elif case == "kfba":
        P, Q, K, tile = 2048, 8, 64, None
        cam = np.zeros((P, Q), np.int32)
        cam[:, 0] = rng.integers(0, K, P)
        cam = cam.reshape(-1)
        N = P * Q
    else:  # "wide": K larger than N
        N, K, tile = 2000, 5000, 512
        cam = rng.integers(0, K, N).astype(np.int32)
    return cam, K, tile


def _rows(C, N, seed, dyadic=False):
    rng = np.random.default_rng(seed)
    if dyadic:  # multiples of 1/256: every partial sum is exact in float32
        return (rng.integers(-1024, 1024, (C, N)) / 256).astype(np.float32)
    return rng.normal(size=(C, N)).astype(np.float32)


PLAN_CASES = ["ragged", "hot", "kfba", "wide"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_reduce_plan_invariants(case):
    cam, K, tile = _plan_case(case)
    plan = seg_kernel.reduce_plan(t(cam), K, tile)
    T = plan.tile
    start = n(plan.run_start).astype(np.int64)
    tile_ptr, words = n(plan.tile_ptr), n(plan.words).astype(np.int64)
    n_runs, n_valid = int(tile_ptr[-1]), int(start[-1])
    # Every in-range slot exactly once; ids outside [0,K) dropped.
    valid = (cam >= 0) & (cam < K)
    assert n_valid == valid.sum() and plan.max_runs >= n_runs
    assert (start[n_runs:] == n_valid).all() and (np.diff(start[: n_runs + 1]) > 0).all()
    tile_of = np.repeat(np.arange(len(tile_ptr) - 1), np.diff(start[tile_ptr]))
    local = n(plan.order)[:n_valid].astype(np.int64)
    assert (0 <= local).all() and (local < T).all()
    slots = tile_of * T + local
    np.testing.assert_array_equal(np.sort(slots), np.nonzero(valid)[0])
    # Inside a tile: sorted by camera, slot order within a camera (stable).
    c_sorted = cam[slots]
    same_tile = tile_of[1:] == tile_of[:-1]
    assert (c_sorted[1:][same_tile] >= c_sorted[:-1][same_tile]).all()
    same_run = same_tile & (c_sorted[1:] == c_sorted[:-1])
    assert (slots[1:][same_run] > slots[:-1][same_run]).all()
    # Runs: all of one camera's slots in one tile, one run per (tile,
    # camera); a hot camera is cut at every tile edge.
    run_tile = tile_of[start[:n_runs]]
    run_cam = c_sorted[start[:n_runs]]
    np.testing.assert_array_equal(n(run_cameras(plan)), run_cam)
    for r in range(n_runs):
        a, b = start[r], start[r + 1]
        assert (tile_of[a:b] == run_tile[r]).all() and (c_sorted[a:b] == run_cam[r]).all()
        assert tile_ptr[run_tile[r]] <= r < tile_ptr[run_tile[r] + 1]
    pairs = run_tile * K + run_cam
    assert (np.diff(pairs) > 0).all()
    np.testing.assert_array_equal(pairs, np.unique(tile_of * K + c_sorted))
    # Second pass: in tile t, bit l of words[t, w] marks camera 32 w + l,
    # whose run is base + the set bits below l.
    mask, base = words[..., 0] & 0xFFFFFFFF, words[..., 1]
    assert words.shape == (len(tile_ptr) - 1, -(-K // 32), 2)
    for r in range(n_runs):
        tt, k = int(run_tile[r]), int(run_cam[r])
        m = int(mask[tt, k // 32])
        assert m >> (k % 32) & 1 and base[tt, k // 32] + bin(m & ((1 << (k % 32)) - 1)).count("1") == r
    assert sum(bin(int(m)).count("1") for m in mask.reshape(-1)) == n_runs
    if case in ("hot", "kfba"):
        k = np.bincount(cam[valid], minlength=K).argmax()
        per_tile = np.bincount(np.nonzero(cam == k)[0] // T)
        assert (run_cam == k).sum() == (per_tile > 0).sum() > 1
        assert per_tile.max() > seg_kernel.WARP_RUN  # a warp's run


@pytest.mark.parametrize("case", PLAN_CASES)
def test_walk_matches_jax(case):
    """The kernel's order of additions against the Pallas kernel (interpret
    mode) and the XLA version; bit-equal on dyadic rows."""
    cam, K, tile = _plan_case(case)
    plan = seg_kernel.reduce_plan(t(cam), K, tile)
    data = _rows(6, len(cam), seed=1)
    got = n(cam_reduce_walk(t(data), plan))
    want = np.asarray(jseg.cam_reduce(jnp.asarray(data), jnp.asarray(cam), K, interpret=True))
    np.testing.assert_allclose(got, want, rtol=REDUCE_RTOL, atol=REDUCE_ATOL)
    valid = (cam >= 0) & (cam < K)
    xla = np.asarray(jseg.cam_reduce_xla(jnp.asarray(data[:, valid]), jnp.asarray(cam[valid]), K))
    np.testing.assert_allclose(got, xla, rtol=REDUCE_RTOL, atol=REDUCE_ATOL)
    dy = _rows(6, len(cam), seed=2, dyadic=True)
    got_dy = n(cam_reduce_walk(t(dy), plan))
    xla_dy = np.asarray(jseg.cam_reduce_xla(jnp.asarray(dy[:, valid]), jnp.asarray(cam[valid]), K))
    np.testing.assert_array_equal(got_dy, xla_dy)
    np.testing.assert_array_equal(got_dy, n(seg_kernel.cam_reduce_torch(t(dy), t(cam), K)))


@pytest.mark.parametrize("case", PLAN_CASES)
def test_walk_error_within_float32_bound(case):
    """B4's order of additions against float64 sums: within the bound that
    holds for any order of float32 additions and, where thousands of slots
    share a camera, no farther off than index_add_'s sum in slot order."""
    cam, K, tile = _plan_case(case)
    data = t(_rows(6, len(cam), seed=3))
    exact, bound = exact_reduce(data, t(cam), K)
    err = (cam_reduce_walk(data, seg_kernel.reduce_plan(t(cam), K, tile)).double() - exact).abs()
    assert (err <= bound).all()
    if case in ("hot", "kfba"):
        seq = (seg_kernel.cam_reduce_torch(data, t(cam), K).double() - exact).abs()
        assert err.max() <= seq.max()


# ---------------------------------------------------------------------------
# B5's launch geometry (seg_kernel.expand_geometry), chosen on the host from
# the shapes: checked here for an H100 (132 SMs, 50 MB of L2).

H100_SMS, H100_L2 = 132, 50 * 1024 * 1024
EXPAND_SHAPES = {  # (C, N), the number of channel chunks
    "config5_c12": ((12, 1 << 22), 1),  # the projection's expand
    "config5_c6": ((6, 1 << 22), 1),  # the matvec's
    "kfba": ((12, 16384), 6),  # the keyframe BA's: N too short for one chunk
    "ragged": ((5, 100003), 1),
    "short": ((4, 3), 4),
    "single": ((1, 1), 1),
    "wide": ((3, 50000), 2),  # the card test's K = 100,000 shape
}


def _expand_slots(q, vec4):
    """The 4 slots of B5's groups q (csrc/seg.cu `slot_of`), a trailing axis."""
    q, j = np.asarray(q)[..., None], np.arange(4)
    return 4 * q + j if vec4 else q // 32 * 128 + q % 32 + 32 * j


@pytest.mark.parametrize("case", sorted(EXPAND_SHAPES))
def test_expand_geometry_covers_every_output(case):
    """The chunks cover every channel once, the blocks every 4-slot group
    once and the groups every slot once, on the 16-byte and the 4-byte
    path; one 1024-thread block an SM where N is long, at least one block
    an SM where it is short; 16-byte paths only where N % 4 == 0 and the ids
    are aligned; evict-first stores only past L2."""
    (C, N), chunks = EXPAND_SHAPES[case]
    g = seg_kernel.expand_geometry(C, N, H100_SMS, H100_L2)
    assert g.chunks == chunks == -(-C // g.ck)
    chans = [c for y in range(g.chunks) for c in range(y * g.ck, min(C, (y + 1) * g.ck))]
    assert chans == list(range(C)) and (g.chunks - 1) * g.ck < C
    for vec4 in {g.vec4, False}:  # the geometry's path, and the 4-byte one at every shape
        groups = seg_kernel.expand_groups(N, vec4)
        stride = g.grid_x * g.threads
        walked = (np.arange(stride)[:, None] + stride * np.arange(-(-groups // stride))[None]).ravel()
        walked = np.sort(walked[walked < groups])
        np.testing.assert_array_equal(walked, np.arange(groups))
        slots = _expand_slots(walked, vec4).ravel()
        np.testing.assert_array_equal(np.sort(slots[slots < N]), np.arange(N))
    assert g.threads % 32 == 0 and g.threads <= seg_kernel.EXPAND_THREADS
    assert g.vec4 == (N % 4 == 0) and g.evict_first == (4 * C * N > H100_L2)
    assert not seg_kernel.expand_geometry(C, N, H100_SMS, H100_L2, vec4=False).vec4
    if case.startswith("config5"):  # one 1024-thread block an SM, all resident at once
        assert (g.threads, g.grid_x) == (seg_kernel.EXPAND_THREADS, H100_SMS)
    if case in ("kfba", "wide"):  # at least one block an SM
        assert g.grid_x * g.chunks >= H100_SMS


def test_reduce_plan_default_tiles_and_bound():
    """Tiles of 1024 to 16384 slots; the run bound needs no device read."""
    assert seg_kernel.default_tile(16384) == 1024
    assert seg_kernel.default_tile(1 << 22) == seg_kernel.MAX_TILE
    assert seg_kernel.max_runs(1 << 22, 5000, 16384) == 256 * 5000
    assert seg_kernel.max_runs(50000, 100000, 1024) == 50000
    with pytest.raises(ValueError):
        seg_kernel.reduce_plan(t(np.zeros(10, np.int32)), 4, tile=100)
    with pytest.raises(ValueError):
        seg_kernel.reduce_plan(t(np.zeros(10, np.int64)), 4)
    empty = seg_kernel.reduce_plan(t(np.zeros(0, np.int32)), 4)
    assert int(empty.tile_ptr[-1]) == 0
    assert not cam_reduce_walk(torch.zeros((2, 0)), empty).any()
