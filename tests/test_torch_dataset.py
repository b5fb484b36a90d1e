"""The port's dataset reader (utils/dataset.py) and native PNG loader
(native/) against the JAX package's reader and PIL, on an ICL-NUIM-layout
directory the test writes to tmp_path: 8-bit RGB and 16-bit depth PNGs at
640x480, associations.txt and a TUM ground truth.

Only the JAX reader's PIL methods are called (rgb, gray, depth,
ground_truth), never its frames() or async_loader: those build the JAX
package's own native library in its source tree. Every comparison is exact.
"""
import hashlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from visual_slam_tpu.utils import dataset as jdataset

from visual_slam_tpu_torch import native
from visual_slam_tpu_torch.utils import dataset

N, H, W = 6, 480, 640
JAX_NATIVE_SO = Path(jdataset.__file__).resolve().parents[1] / "native" / "libvslam_native.so"


@pytest.fixture(scope="module")
def icl_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("icl")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(N):
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(root / "rgb" / f"{i}.png")
        depth = rng.integers(0, 40000, (H, W), dtype=np.uint16)
        depth[::13, ::7] = 0  # missing depth
        Image.fromarray(depth).save(root / "depth" / f"{i}.png")
        lines.append(f"{i} depth/{i}.png {i} rgb/{i}.png")
    lines.insert(2, "a malformed line")
    (root / "associations.txt").write_text("\n".join(lines) + "\n")
    q = rng.normal(size=(N, 4))
    rows = np.concatenate([np.arange(1, N + 1)[:, None], rng.normal(size=(N, 3)), q], axis=1)
    np.savetxt(root / "traj3.gt.freiburg", rows)
    return str(root)


def test_reader_matches_jax(icl_dir):
    """len, rgb, gray, depth, intrinsics and ground_truth equal the JAX
    reader's; the malformed association line is skipped by both."""
    ours, theirs = dataset.ICLNUIMDataset(icl_dir), jdataset.ICLNUIMDataset(icl_dir)
    assert len(ours) == len(theirs) == N
    np.testing.assert_array_equal(ours.intrinsics, theirs.intrinsics)
    for i in range(N):
        for name in ("rgb", "gray", "depth"):
            a, b = getattr(ours, name)(i), getattr(theirs, name)(i)
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, name)
    assert ours.depth(0).dtype == np.float32 and (ours.depth(0) == 0).any()
    np.testing.assert_array_equal(ours.ground_truth(), theirs.ground_truth())


@pytest.mark.parametrize("kw", [dict(offset=1), dict(offset=2, step=2), dict(offset=1, length=3, reverse=True)])
def test_window_view_matches_jax(icl_dir, kw):
    """WindowView: the same length, frame mapping, images and re-indexed
    ground truth as the JAX package's over the same base."""
    ours = dataset.WindowView(dataset.ICLNUIMDataset(icl_dir), **kw)
    theirs = jdataset.WindowView(jdataset.ICLNUIMDataset(icl_dir), **kw)
    assert len(ours) == len(theirs) > 0
    assert [ours._map(i) for i in range(len(ours))] == [theirs._map(i) for i in range(len(theirs))]
    for i in range(len(ours)):
        assert np.array_equal(ours.gray(i), theirs.gray(i))
        assert np.array_equal(ours.depth(i), theirs.depth(i))
    np.testing.assert_array_equal(ours.ground_truth(), theirs.ground_truth())
    assert [i for i, _, _ in ours.frames()] == list(range(len(ours)))


def test_tum_rows_to_matrices_matches_jax():
    rng = np.random.default_rng(1)
    rows = np.concatenate([np.arange(20)[:, None], rng.normal(size=(20, 7))], axis=1)
    rows[3, 4:8] = 0  # a zero quaternion
    np.testing.assert_array_equal(dataset.tum_rows_to_matrices(rows), jdataset.tum_rows_to_matrices(rows))


def _sha(path: Path) -> str | None:
    return hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() else None


@pytest.fixture(scope="module")
def loader_built():
    before = _sha(JAX_NATIVE_SO)
    if not native.available():
        pytest.skip(f"the native loader does not build here: {native.build_error}")
    yield
    assert _sha(JAX_NATIVE_SO) == before  # the JAX package's library is left alone


def test_native_loader_matches_pil(icl_dir, loader_built):
    """get() decodes RGB and depth bit-equal to PIL (depth / 5000 as the
    reader's), get_gray() is (299 R + 587 G + 114 B) / 1000 of PIL's RGB,
    close() twice is harmless; the library lands in the git-ignored
    _build/ directory, not beside its source."""
    ds = dataset.ICLNUIMDataset(icl_dir)
    rgb_paths = [a.rgb_path for a in ds.associations]
    dep_paths = [a.depth_path for a in ds.associations]
    loader = native.AsyncFrameLoader(rgb_paths, dep_paths, n_threads=2, lookahead=3)
    try:
        for i in range(N):
            ref_rgb = np.asarray(Image.open(rgb_paths[i]))
            ref_depth = np.asarray(Image.open(dep_paths[i])).astype(np.float32) / 5000.0
            if i % 2:
                rgb, depth = loader.get(i)
                assert np.array_equal(rgb, ref_rgb)
            else:
                gray, depth = loader.get_gray(i)
                want = (ref_rgb.astype(np.uint32) @ np.array([299, 587, 114], np.uint32)) // 1000
                assert gray.dtype == np.uint8 and np.array_equal(gray, want.astype(np.uint8))
            assert np.array_equal(depth, ref_depth) and np.array_equal(depth, ds.depth(i))
    finally:
        loader.close()
    loader.close()
    assert native.library_path().parent == native.BUILD_DIR and native.library_path().exists()
    assert not [f for f in os.listdir(Path(native.__file__).parent) if f.endswith(".so")]


def test_frames_native_and_pil(icl_dir, loader_built, monkeypatch):
    """frames(): with the native loader, uint8 gray (the loader's) and the
    reader's depth; with it unavailable, the PIL path's float gray. Both
    give the front-end the same image up to the integer gray rounding."""
    ds = dataset.ICLNUIMDataset(icl_dir)
    fast = list(ds.frames(1, 4))
    assert [i for i, _, _ in fast] == [1, 2, 3]
    monkeypatch.setattr(native, "available", lambda: False)
    slow = list(ds.frames(1, 4))
    for (i, g8, d8), (j, gf, df) in zip(fast, slow):
        assert i == j and g8.dtype == np.uint8 and gf.dtype == np.float32
        assert np.array_equal(gf, ds.gray(i)) and np.array_equal(d8, df)
        assert np.abs(g8.astype(np.float32) / 255.0 - gf).max() < 1.5 / 255.0
    got = [(i, rgb) for i, rgb, _ in ds.async_frames(0, 2)]
    assert [i for i, _ in got] == [0, 1] and np.array_equal(got[1][1], ds.rgb(1))


def test_synthetic_scene_sequence_interface():
    """The synthetic scene and FrameSequence take WindowView: gray(i) and
    depth(i) are frame i's render, a rendered list gives the same views."""
    from visual_slam_tpu_torch.utils.scene import FrameSequence, SyntheticRGBDScene

    scene = SyntheticRGBDScene(6, 48, 64)
    rendered = FrameSequence(list(scene.frames()), scene.ground_truth())
    for base in (scene, rendered):
        view = dataset.WindowView(base, 1, length=4, reverse=True)
        assert len(view) == 4
        g, d = scene.render(4)
        assert np.array_equal(view.gray(0), g) and np.array_equal(view.depth(0), d)
        np.testing.assert_array_equal(view.ground_truth(), scene.ground_truth()[[4, 3, 2, 1]])
    assert torch.equal(torch.from_numpy(scene.gray(2)), torch.from_numpy(scene.render(2)[0]))


def test_frame_sequence_numbers_frames_one_way():
    """FrameSequence's frames() ids are the positions gray(i) and depth(i)
    read, and a list whose ids are not 0..N-1 is refused."""
    from visual_slam_tpu_torch.utils.scene import FrameSequence, SyntheticRGBDScene

    scene = SyntheticRGBDScene(4, 48, 64)
    seq = FrameSequence(list(scene.frames()))
    for i, g, d in seq.frames():
        assert g is seq.gray(i) and d is seq.depth(i)
    assert [i for i, _, _ in seq.frames(1, 3)] == [1, 2] and len(seq) == 4
    with pytest.raises(ValueError):
        FrameSequence([(i, *scene.render(i)) for i in (0, 2)])
