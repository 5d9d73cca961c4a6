"""The training augmentations: the port's own cv2 operations (``cv_ops``,
with ``csrc/image_ops.cpp``) against cv2, its preprocess functions and
rotation helpers against the JAX package's, and ``BaselineDataset`` with
every augmentation against the JAX package's over a small JPEG corpus.

Bounds, per test:

  * ``get_rotation_matrix_2d``: equal to ``cv2.getRotationMatrix2D`` bit for bit;
  * ``warp_affine_linear``: equal to ``cv2.warpAffine`` (INTER_LINEAR,
    constant border 0) byte for byte at the ten angles of ``random_rotate``
    and at others, at 224x224 (whole vector blocks) and at widths whose last
    columns take OpenCV's scalar code;
  * ``bgr_to_hsv``: equal to cv2 on all 2^24 colours; ``hsv_to_bgr``: equal
    on all 180 x 256 x 256 inputs in whole blocks of 32 pixels, and on
    random rows whose last pixels take the scalar code;
  * ``filter2d``: within 1 on at most 1e-4 of the values (cv2 sums large
    kernels through a DFT, the port directly in float32);
  * ``random_rotate`` / ``color_jitter`` / ``add_motion_blur`` /
    ``load_blur_kernels`` with the same seed as the JAX package's: images by
    the bounds above, joints and orient within 1e-5, the ``random.Random``
    state equal after each call;
  * ``matrix_to_quaternion`` / ``quaternion_to_axis_angle`` /
    ``rotate_orient_z`` / ``rotate_joints_2d`` / ``rotate_joints_3d``: within
    1e-5 of JAX's, near-pi orients included (where Shepperd's pivot changes);
  * the datasets over one epoch with flip, rescale, position, rotation,
    colour jitter and motion blur on: images within one uint8 level on at
    most 1e-4 of the values (filter2D) and equal elsewhere, annotations
    within 1e-5, and the ``random.Random`` state equal at the end (the draw
    order).
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")  # the reference, and the JAX package's data layer imports it

import ihmr_tpu.data as JD  # noqa: E402
from ihmr_tpu.core import rotations as JR  # noqa: E402
from ihmr_tpu.data import preprocess as JP  # noqa: E402
from ihmr_tpu_torch import data as TD  # noqa: E402
from ihmr_tpu_torch.core import rotations as TR  # noqa: E402
from ihmr_tpu_torch.data import cv_ops  # noqa: E402
from ihmr_tpu_torch.data import preprocess as TP  # noqa: E402
from ihmr_tpu_torch.data.image_cases import FIXTURE_DIR, augmentation_input  # noqa: E402
from ihmr_tpu_torch.data.synthetic import (  # noqa: E402
    BLUR_PSFS, motion_psf, use_jpeg_images, write_blur_kernels, write_corpus,
)
from tests.torch_threads import one_torch_thread  # noqa: E402, F401

ANGLES = [180.0 / 10 * i - 90 for i in range(10)]  # random_rotate's ten slices
LEVEL = 2.0 / 255.0  # one uint8 level after the [-1, 1] normalization
FILTER_SHARE = 1e-4
TOL = 1e-5


def _image(height, width, seed, channels=3):
    return np.random.default_rng(seed).integers(0, 256, (height, width, channels), dtype=np.uint8)


def _within_filter_bound(ours, ref):
    diff = np.abs(ours.astype(np.int16) - ref)
    assert diff.max() <= 1 and (diff > 0).mean() <= FILTER_SHARE, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("angle", ANGLES + [33.3, -137.0, 180.0])
def test_rotation_matrix_equals_cv2(angle):
    for center in ((112.0, 112.0), (30.5, 17.25), (0.1, 99.9)):
        np.testing.assert_array_equal(cv_ops.get_rotation_matrix_2d(center, angle, 1.0),
                                      cv2.getRotationMatrix2D(center, angle, 1.0))


@pytest.mark.parametrize("shape", [(224, 224, 3), (61, 61, 3), (37, 100, 3), (50, 15, 3), (45, 70), (1000, 960, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_warp_affine_equals_cv2(shape):
    """(1000, 960, 3) is large enough for the rows to be split over threads."""
    img = _image(*shape[:2], seed=sum(shape), channels=shape[2] if len(shape) == 3 else 1).reshape(shape)
    for angle in ANGLES + [7.7, -151.2, 123.0]:
        m = cv2.getRotationMatrix2D(tuple(np.array(img.shape[1::-1]) / 2), angle, 1.0)
        ref = cv2.warpAffine(img, m, img.shape[1::-1], flags=cv2.INTER_LINEAR)
        ours = cv_ops.warp_affine_linear(img, m, img.shape[1::-1])
        assert ours.shape == ref.shape and np.array_equal(ours, ref), (angle, np.count_nonzero(ours != ref))


def test_bgr_to_hsv_equals_cv2_on_every_colour():
    colours = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([colours & 255, (colours >> 8) & 255, colours >> 16], -1).astype(np.uint8).reshape(-1, 256, 3)
    assert np.array_equal(cv_ops.bgr_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_BGR2HSV))


def test_hsv_to_bgr_equals_cv2():
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 256, 3)  # whole blocks of 32
    assert np.array_equal(cv_ops.hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    for width in (1, 7, 33, 100, 250):  # 1 to 31 trailing pixels a row
        img = _image(400, width, seed=width)
        img[..., 0] %= 181
        assert np.array_equal(cv_ops.hsv_to_bgr(img), cv2.cvtColor(img, cv2.COLOR_HSV2BGR)), width


@pytest.mark.parametrize("kernel", ["psf15", "psf31", "dense3", "dense11", "dense15", "sparse31", "dense15_large"])
def test_filter2d_within_one(kernel):
    """``dense15_large`` filters a 1000x960 image: enough work to split its rows over threads."""
    rng = np.random.default_rng(len(kernel))
    if kernel.startswith("psf"):
        size = int(kernel[3:])
        k = motion_psf(size, dict(BLUR_PSFS)[size])
    else:
        size = int(kernel[5:7] if kernel.startswith("dense") else kernel[6:])
        k = rng.random((size, size)).astype(np.float32)
        if kernel.startswith("sparse"):
            k[rng.random((size, size)) < 0.9] = 0
        k /= k.sum()
    img = cv2.GaussianBlur(_image(*((1000, 960) if kernel.endswith("large") else (224, 224)), seed=size), (5, 5), 0)
    _within_filter_bound(cv_ops.filter2d(img, k), cv2.filter2D(img, -1, k))
    gray = img[:37, :53, 0].copy()  # smaller than the 31x31 kernel's reach: reflected more than once
    _within_filter_bound(cv_ops.filter2d(gray, k), cv2.filter2D(gray, -1, k))


@pytest.fixture(scope="module")
def blur_dir(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("blur"))
    write_blur_kernels(directory)
    return directory


def test_load_blur_kernels_matches_jax(blur_dir):
    ours, ref = TP.load_blur_kernels(blur_dir), JP.load_blur_kernels(blur_dir)
    assert [k.shape for k in ours] == [(s, s) for s, _ in BLUR_PSFS]
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
        assert abs(float(a.sum()) - 1.0) < 1e-6


def _inputs(seed):
    rng = np.random.default_rng(seed)
    img = augmentation_input() if seed == 0 else _image(224, 224, seed)
    j2 = np.concatenate([rng.uniform(0, 224, (42, 2)), rng.integers(0, 2, (42, 1))], 1).astype(np.float32)
    j3 = np.concatenate([rng.normal(0, 0.1, (42, 3)), np.ones((42, 1))], 1).astype(np.float32)
    pose = rng.normal(0, 1.0, 96).astype(np.float32)
    return img, j2, j3, pose


@pytest.mark.parametrize("seed", range(4))
def test_preprocess_functions_match_jax(seed, blur_dir):
    """random_rotate over 12 draws, color_jitter over 3 and add_motion_blur
    over 6, each from random.Random(seed) in both packages."""
    img, j2, j3, pose = _inputs(seed)
    rj, rt = random.Random(seed), random.Random(seed)
    for _ in range(12):
        a, b = JP.random_rotate(img, j2, j3, pose, rj), TP.random_rotate(img, j2, j3, pose, rt)
        assert np.array_equal(a[0], b[0])
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_allclose(y, x, atol=TOL, rtol=0)
        assert rj.getstate() == rt.getstate()
    for _ in range(3):
        assert np.array_equal(JP.color_jitter(img, rj), TP.color_jitter(img, rt))
        assert rj.getstate() == rt.getstate()
    kj, kt = JP.load_blur_kernels(blur_dir), TP.load_blur_kernels(blur_dir)
    blurred = 0
    for _ in range(6):
        a, b = JP.add_motion_blur(img, kj, rj), TP.add_motion_blur(img, kt, rt)
        _within_filter_bound(b, a)
        blurred += int(a is not img)
        assert rj.getstate() == rt.getstate()
    assert 0 < blurred < 6
    assert TP.add_motion_blur(img, [], rt) is img and rj.getstate() == rt.getstate()


def _rotation_matrices():
    rng = np.random.default_rng(11)
    aa = [rng.normal(0, 1.5, 3) for _ in range(64)]
    for axis in np.eye(3):  # near pi about each axis: the trace pivot gives way to m00, m11 or m22
        for angle in (np.pi - 1e-3, np.pi - 1e-5, np.pi):
            aa.append(axis * angle)
            tilted = axis + np.array([0.01, -0.02, 0.015])
            aa.append(tilted / np.linalg.norm(tilted) * angle)
    aa += [np.zeros(3), np.array([1e-9, 0.0, 0.0]), np.array([0.0, 0.0, 3e-4])]
    aa = np.asarray(aa, np.float32)
    return aa, np.array(JR.axis_angle_to_matrix(jnp.asarray(aa)))


def test_quaternion_conversions_match_jax():
    aa, mats = _rotation_matrices()
    q_ref = np.array(jax.jit(JR.matrix_to_quaternion)(jnp.asarray(mats)))
    q = TR.matrix_to_quaternion(torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(q, q_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(TR.quaternion_to_axis_angle(torch.from_numpy(q_ref)).numpy(),
                               np.asarray(JR.quaternion_to_axis_angle(jnp.asarray(q_ref))), atol=TOL, rtol=0)
    np.testing.assert_allclose(TR.matrix_to_axis_angle(torch.from_numpy(mats)).numpy(),
                               np.asarray(JR.matrix_to_axis_angle(jnp.asarray(mats))), atol=TOL, rtol=0)


@pytest.mark.parametrize("angle", ANGLES)
def test_rotation_helpers_match_jax(angle):
    aa, _ = _rotation_matrices()
    for orient in aa[::3]:
        ours, ref = TR.rotate_orient_z(orient, angle), JR.rotate_orient_z(orient, angle)
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    rng = np.random.default_rng(int(angle) + 100)
    j2 = rng.uniform(0, 224, (42, 2)).astype(np.float32)
    origin = np.array([[112.0, 112.0]])
    ours, ref = TR.rotate_joints_2d(j2, origin, angle), JR.rotate_joints_2d(j2, origin, angle)
    assert ours.dtype == ref.dtype == np.float64 and np.array_equal(ours, ref)
    j3 = rng.normal(0, 0.1, (42, 3)).astype(np.float32)
    ours, ref = TR.rotate_joints_3d(j3, angle), JR.rotate_joints_3d(j3, angle)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def jpeg_corpus(tmp_path_factory, blur_dir):
    root = str(tmp_path_factory.mktemp("jpeg_corpus"))
    write_corpus(root, 8, seed=4)
    use_jpeg_images(root, [os.path.join(FIXTURE_DIR, n) for n in ("corpus_256x192.jpg", "corpus_192x256.jpg")])
    return root


def test_baseline_datasets_with_every_augmentation_match_jax(jpeg_corpus, blur_dir):
    aug = dict(is_train=True, use_random_flip=True, use_random_rescale=True, use_random_position=True,
               use_random_rotation=True, use_color_jittering=True, use_motion_blur=True, blur_kernel_dir=blur_dir)
    kw = dict(data_root=jpeg_corpus, anno_path="anno.pkl", batch_size=4, input_size=224, **aug)
    j, t = JD.BaselineDataset(JD.DataConfig(**kw), seed=5), TD.BaselineDataset(TD.DataConfig(**kw), seed=5)
    for ds in (j, t):
        ds.load_data()
        ds.shuffle_data()
    assert [a["img_path"] for a in t.data_list] == [a["img_path"] for a in j.data_list]
    assert all(p.endswith(".jpg") for p in (a["img_path"] for a in t.data_list))
    for i in range(len(j)):
        ref, ours = j[i], t[i]
        assert set(ours) == set(ref)
        diff = np.abs(ours["img"] - ref["img"])
        assert diff.max() <= LEVEL + 1e-6 and (diff > 1e-6).mean() <= FILTER_SHARE, (i, diff.max())
        for k in ref:
            if k != "img":
                assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
                np.testing.assert_allclose(ours[k], ref[k], atol=TOL, rtol=0, err_msg=k)
    assert t.rng.getstate() == j.rng.getstate()
