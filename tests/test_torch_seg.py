"""Kernels B4/B5 (camera-segment reduce and expand) of visual_slam_tpu_torch:
their plain PyTorch versions against the JAX package's Pallas kernels run in
interpret mode on the CPU, the out-of-range rule, the wrappers' device rule,
and the scale-edge terms of ops/lie beside them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t

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
