"""Shared helpers for the parity tests of visual_slam_tpu_torch against the
JAX package. Inputs are made with NumPy from a seed and handed to both
sides as arrays; the JAX side runs on the CPU as its own tests run it
(Pallas kernels in interpret mode)."""
import numpy as np
import scipy.ndimage as ndi
import torch

# The tier-1 run uses 6 pytest workers on a shared machine: keep each
# worker's intra-op pool small.
torch.set_num_threads(2)

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


def t(a, dtype=None):
    """NumPy (or JAX) array -> CPU tensor."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x):
    """Tensor -> NumPy."""
    return x.detach().cpu().numpy()


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
