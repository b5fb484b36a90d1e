"""Shared helpers for the parity tests of visual_slam_tpu_torch against the
JAX package. Inputs are made with NumPy from a seed and handed to both
sides as arrays; the JAX side runs on the CPU as its own tests run it
(Pallas kernels in interpret mode)."""
import numpy as np
import scipy.ndimage as ndi
import torch

from visual_slam_tpu_torch.ops.kernels import seg_kernel
from visual_slam_tpu_torch.ops.kernels.seg_kernel import TILE_GROUPS, WARP_RUN

# One intra-op thread a pytest worker. torch's CPU sqrt runs MKL's vector
# math in 2,048-element chunks over the intra-op threads; with two threads,
# in a fresh worker under load, the second thread's chunk of the first
# call has come back ~2e-4 off (ROADMAP, Queue C).
torch.set_num_threads(1)

ICL_INTR = np.array([481.20, 480.0, 319.5, 239.5], np.float32)


def checkerboard(h=480, w=640, cell=40):
    """The tests/test_frontend.py checkerboard (plateau ties everywhere)."""
    y = np.arange(h)[:, None] // cell
    x = np.arange(w)[None, :] // cell
    return ((y + x) % 2).astype(np.float32)


def smooth_noise(h=480, w=640, sigma=3.0, seed=0):
    """Gaussian-smoothed uniform noise, as in test_descriptor_shift_invariance."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, size=(h, w)).astype(np.float32)
    return ndi.gaussian_filter(base, sigma).astype(np.float32)


# Kernel B1's ragged sizes: no side a multiple of its 60x20 tile, a quarter
# frame, images narrower or shorter than a tile, and one no larger than the
# 16 px border frame (every peak -inf).
RAGGED_SIZES = [(479, 637), (240, 320), (45, 70), (37, 600), (30, 30)]


def uniform_noise(h, w, seed=0):
    """Uniform noise in [0, 1), float32, from a NumPy seed."""
    return np.random.default_rng(seed).uniform(0, 1, (h, w)).astype(np.float32)


def t(a, dtype=None):
    """NumPy (or JAX) array -> CPU tensor."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x):
    """Tensor -> NumPy."""
    return x.detach().cpu().numpy()


def check_or_recompute(check, port_fn, jax_fn) -> None:
    """check(port, jax) on one computation of each side (tuples of arrays or
    tensors). If it fails, both sides are computed again and the message
    says, for each output of each side, how many entries the second
    computation changed and by how much, so a one-off mismatch (ROADMAP
    Queue C) names the side and the output that changed."""
    port, jx = port_fn(), jax_fn()
    try:
        check(port, jx)
    except AssertionError as e:
        def changes(first, again):
            out = []
            for i, (a, b) in enumerate(zip(first, again)):
                a, b = np.asarray(a), np.asarray(b)
                moved = (a != b) & ~(np.isnan(a) & np.isnan(b)) if a.dtype.kind == "f" else a != b
                big = np.abs(a.astype(np.float64) - b)[moved].max() if moved.any() else 0.0
                out.append(f"[{i}] {int(moved.sum())} of {a.size} changed, max {big:.3g}")
            return "; ".join(out)

        raise AssertionError(f"{e}\ncomputed again: port {changes(port, port_fn())}; "
                             f"JAX {changes(jx, jax_fn())}") from e


def desc_bits(desc_u32: np.ndarray) -> np.ndarray:
    """(K,8) uint32 -> (K,256) bool, bit s of word w = bit 32w+s."""
    d = np.ascontiguousarray(desc_u32, dtype=np.uint32)
    return np.unpackbits(d.view(np.uint8), axis=1, bitorder="little").astype(bool)


def edge_keypoints(H, W, K, seed=0):
    """K keypoints: random ones plus some whose patches clamp at all four edges."""
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(0, W - 1, K), rng.uniform(0, H - 1, K)], -1)
    uv[:8] = [[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1],
              [3.7, H / 2], [W - 2.2, H / 3], [W / 2, 1.5], [W / 3, H - 4.9]]
    return uv.astype(np.float32)


# Kernel B4's order of additions (csrc/seg.cu), replayed in PyTorch over a
# seg_kernel.reduce_plan: the CPU tests hold it against the JAX package, the
# card tests hold the kernel bit-equal to it.

def run_cameras(plan) -> torch.Tensor:
    """(n_runs,) int64: the camera of each run, read back from the plan's
    masks (the kernel never needs it)."""
    n_tiles, W, _ = plan.words.shape
    n_runs = int(plan.tile_ptr[-1])
    mask, base = plan.words[..., 0].long() & 0xFFFFFFFF, plan.words[..., 1].long()
    bit = torch.arange(32, device=mask.device)
    has = (mask[..., None] >> bit) & 1 == 1  # (n_tiles, W, 32)
    rank = torch.cumsum(has, -1) - has.long()
    cams = torch.full((n_runs + 1,), -1, dtype=torch.int64, device=mask.device)
    run = torch.where(has, base[..., None] + rank, n_runs)
    cams[run.reshape(-1)] = (torch.arange(W, device=mask.device)[:, None] * 32 + bit).expand(
        n_tiles, W, 32).reshape(-1)
    return cams[:n_runs]


def cam_reduce_walk(data: torch.Tensor, plan) -> torch.Tensor:
    """B4's additions, in B4's order, in PyTorch: (C,N) -> (C,K), the same
    bits as the kernel. Pass 1 sums each run of at most WARP_RUN slots in
    slot order from 0; a longer run gives lane l the slots l, l+32, ...,
    each summed in order from 0, then adds the 32 lane sums as the kernel's
    shuffle tree does. Pass 2 adds each camera's run sums in tile order,
    from 0, in TILE_GROUPS shares of the tiles, then the shares' sums in
    order. Reads a few sizes on the host; a reference, not a fast path."""
    C, N = data.shape
    T, K, dev = plan.tile, plan.K, data.device
    start = plan.run_start.long()
    n_runs, n_valid = int(plan.tile_ptr[-1]), int(start[-1])
    tile_first = start[plan.tile_ptr.long()]
    tile_of = torch.searchsorted(tile_first, torch.arange(n_valid, device=dev), right=True) - 1
    vals = torch.cat([data[:, tile_of * T + plan.order[:n_valid].long()],
                      torch.zeros((C, 1), dtype=data.dtype, device=dev)], dim=1)  # column n_valid: 0
    s, length = start[:n_runs], start[1:n_runs + 1] - start[:n_runs]

    def slot(r, i):  # the i-th slot of runs r, or the zero column past a run's end
        return torch.where(i < length[r], s[r] + i, n_valid)

    run = torch.zeros((C, n_runs), dtype=data.dtype, device=dev)
    short = torch.nonzero(length <= WARP_RUN).squeeze(1)
    acc = torch.zeros((C, len(short)), dtype=data.dtype, device=dev)
    for i in range(WARP_RUN):
        acc = acc + vals[:, slot(short, i)]
    run[:, short] = acc
    long_ = torch.nonzero(length > WARP_RUN).squeeze(1)
    if len(long_):
        lanes = torch.zeros((C, len(long_), 32), dtype=data.dtype, device=dev)
        lane = torch.arange(32, device=dev)
        for i in range(0, int(length[long_].max()), 32):
            lanes = lanes + vals[:, slot(long_[:, None], i + lane)]
        for off in (16, 8, 4, 2, 1):
            lanes = lanes[..., :off] + lanes[..., off:2 * off]
        run[:, long_] = lanes[..., 0]
    # Pass 2: share q of the tiles (TILE_GROUPS shares of ceil(n_tiles /
    # TILE_GROUPS)), each camera's runs there in tile order from 0; then the
    # shares' sums in order.
    n_tiles = plan.tile_ptr.shape[0] - 1
    share = max(-(-n_tiles // TILE_GROUPS), 1)
    key = run_cameras(plan) * TILE_GROUPS + tile_of[s] // share
    by_key = torch.sort(key, stable=True).indices  # tile order within a (camera, share)
    first = torch.searchsorted(key[by_key], torch.arange(K * TILE_GROUPS + 1, device=dev))
    cnt = first[1:] - first[:-1]
    run = torch.cat([run, torch.zeros((C, 1), dtype=data.dtype, device=dev)], dim=1)
    part = torch.zeros((C, K * TILE_GROUPS), dtype=data.dtype, device=dev)
    for i in range(int(cnt.max()) if n_runs else 0):
        r = torch.where(i < cnt, by_key[(first[:-1] + i).clamp(max=max(n_runs - 1, 0))], n_runs)
        part = part + run[:, r]
    part = part.reshape(C, K, TILE_GROUPS)
    out = part[..., 0]
    for q in range(1, TILE_GROUPS):
        out = out + part[..., q]
    return out


def exact_reduce(data: torch.Tensor, cam: torch.Tensor, K: int):
    """B4's function in float64 on float32 rows (C,N): ((C,K) sums, (C,K)
    bound). The bound is the most that any order of float32 additions may
    be off: gamma_(n-1) * sum |x| over a camera's n slots, with
    gamma_m = m u / (1 - m u) and u = 2^-24 (Higham, Accuracy and Stability
    of Numerical Algorithms, 2nd ed., eq. 4.6)."""
    d = data.double()
    exact = seg_kernel.cam_reduce_torch(d, cam, K)
    abs_sum = seg_kernel.cam_reduce_torch(d.abs(), cam, K)
    m = (seg_kernel.cam_reduce_torch(torch.ones_like(d[:1]), cam, K) - 1).clamp(min=0) * 2.0 ** -24
    return exact, m / (1 - m) * abs_sum
