"""The data layer, the MANO pkl loader and the ResNet importer: the port
against the JAX package on the same files.

The corpus is ``tests/test_data.py::_write_synthetic_corpus`` (cv2-written
120x90 PNGs, interacting / right / left in turn), read by both packages.
Bounds, per test:

  * ``image_io.imread``: equal to ``cv2.imread`` byte for byte;
  * ``image_io.resize_linear``: equal to ``cv2.resize`` (INTER_LINEAR) byte
    for byte (the datasets need one uint8 level; every pixel of every case
    here is exact with cv2 5.0);
  * the native letterbox: bit-equal to ``ihmr_tpu.native`` (JAX's native
    library must be built, so that JAX takes that path too);
  * dataset items: every non-image array exactly equal, or within 1e-6 where
    the native letterbox's float32 ratio enters (the 2D joints of the
    prediction datasets); images within one uint8 level (2/255 after the
    [-1, 1] normalization) from ``padding_and_resize``, bit-equal from the
    native letterbox;
  * ``BatchLoader`` indices and batches, ``ComposeDataset``,
    ``load_annotation`` of a directory, the MANO pkl arrays, face order and
    ``hands_mean``, and the imported ResNet state dict: exactly equal.
"""

import dataclasses
import os
import os.path as osp

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ihmr_tpu.data as JD
from ihmr_tpu import native as jax_native
from ihmr_tpu.mano import loader as JML
from ihmr_tpu.models.encoder import InterHandEncoder as FlaxEncoder
from ihmr_tpu.train import checkpoint as JCK
from ihmr_tpu.utils import io_utils as jax_io
from ihmr_tpu_torch import convert
from ihmr_tpu_torch import data as TD
from ihmr_tpu_torch.data import image_io, native
from ihmr_tpu_torch.data import preprocess as TP
from ihmr_tpu_torch.mano import loader as TML
from ihmr_tpu_torch.models.encoder import InterHandEncoder
from ihmr_tpu_torch.train import checkpoint as TCK
from ihmr_tpu_torch.utils import io_utils
from tests.test_data import _write_synthetic_corpus
from tests.test_mano_loader import _write_fake_mano
from tests.torch_threads import one_torch_thread  # noqa: F401

LEVEL = 2.0 / 255.0  # one uint8 level after the [-1, 1] normalization


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX tests' corpus (6 samples), an annotation pkl where sample 1
    has no left-hand MANO param, and an OPT pseudo-GT pkl for every sample."""
    root = str(tmp_path_factory.mktemp("port_corpus"))
    annos, _ = _write_synthetic_corpus(root, n=6)
    missing = [dict(a) for a in annos]
    missing[1]["left_hand_param"] = None
    jax_io.save_pkl(osp.join(root, "anno_missing.pkl"), missing)
    rng = np.random.RandomState(7)
    pgt = {
        a["img_path"]: dict(
            opt_pose_params=rng.randn(96).astype(np.float32) * 0.1,
            opt_shape_params=rng.randn(20).astype(np.float32) * 0.3,
            opt_hand_trans=rng.randn(3).astype(np.float32) * 0.02,
        )
        for a in annos
    }
    jax_io.save_pkl(osp.join(root, "opt_pgt.pkl"), pgt)
    return root


# ---------------------------------------------------------------------------
# image files and resizing


def _images():
    rng = np.random.RandomState(3)
    noise = (rng.rand(37, 29, 3) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:48]
    smooth = np.stack([(xx * 5) % 256, (yy * 3) % 256, (xx * yy) % 256], -1).astype(np.uint8)
    return {"noise": noise, "smooth": smooth}


@pytest.mark.parametrize("kind", ["bgr", "gray", "bgra"])
@pytest.mark.parametrize("name", ["noise", "smooth"])
def test_imread_matches_cv2_on_cv2_pngs(tmp_path, kind, name):
    """Bound: equal byte for byte. cv2 picks its own row filters."""
    img = _images()[name]
    img = {"bgr": img, "gray": img[..., 1], "bgra": np.concatenate([img, img[..., :1]], -1)}[kind]
    path = str(tmp_path / f"{name}_{kind}.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))


@pytest.mark.parametrize("filters", [None, (0,), (1,), (2,), (3,), (4,)], ids=lambda f: f"filters{f}")
def test_imread_reads_own_pngs(tmp_path, filters):
    """The port's writer (each row filter alone, and all five in turn) read
    back by the port and by cv2. Bound: equal byte for byte."""
    img = _images()["noise"]
    path = str(tmp_path / "own.png")
    image_io.imwrite_png(path, img, filters=filters)
    np.testing.assert_array_equal(image_io.imread(path), img)
    np.testing.assert_array_equal(cv2.imread(path), img)


def test_imread_corpus_and_jpeg_path(corpus, tmp_path):
    """The corpus PNGs equal cv2's reading; a JPEG goes through cv2 (here,
    where it is installed) and gives cv2's pixels. Bound: equal."""
    for name in sorted(os.listdir(osp.join(corpus, "hand26m/image"))):
        path = osp.join(corpus, "hand26m/image", name)
        np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))
    jpg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpg, _images()["smooth"])
    np.testing.assert_array_equal(image_io.imread(jpg), cv2.imread(jpg))
    bad = tmp_path / "x.bmp"
    bad.write_bytes(b"BM" + bytes(64))
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        image_io.imread(str(bad))


@pytest.mark.parametrize(
    "src,dst",
    [((256, 192), (168, 224)), ((192, 256), (224, 168)), ((480, 640), (224, 168)), ((120, 90), (168, 224)),
     ((90, 120), (224, 168)), ((200, 300), (224, 149)), ((448, 336), (168, 224)), ((224, 224), (134, 134)),
     ((7, 9), (3, 4))],
    ids=lambda s: "x".join(map(str, s)),
)
def test_resize_linear_matches_cv2(src, dst):
    """Downscales, upscales, an exact halving (OpenCV's area path) and an
    odd tiny case, on noise and on saturated 0/255 pixels. Bound: equal byte
    for byte (share of exact pixels: 100%)."""
    rng = np.random.RandomState(sum(src) + sum(dst))
    for img in ((rng.rand(*src, 3) * 255).astype(np.uint8), rng.choice([0, 255], size=(*src, 3)).astype(np.uint8)):
        np.testing.assert_array_equal(image_io.resize_linear(img, dst), cv2.resize(img, dst))


def test_native_letterbox_bit_equal():
    """The port's copy of the native library against the JAX package's, on
    both letterbox branches and an odd size: images and ratios bit-equal."""
    assert jax_native.available(), "the JAX package's native library did not build"
    rng = np.random.RandomState(5)
    for shape in ((256, 192, 3), (192, 256, 3), (120, 90, 3), (31, 57, 3)):
        img = (rng.rand(*shape) * 255).astype(np.uint8)
        ours, r_ours = native.letterbox_normalize(img, 224)
        ref, r_ref = jax_native.letterbox_normalize(img, 224)
        np.testing.assert_array_equal(ours, ref)
        assert r_ours == r_ref
        batch = np.stack([img, img[::-1]])
        (o, ro), (f, rf) = native.letterbox_normalize_batch(batch, 64), jax_native.letterbox_normalize_batch(batch, 64)
        np.testing.assert_array_equal(o, f)
        np.testing.assert_array_equal(ro, rf)
        np.testing.assert_array_equal(native.normalize_batch(batch), jax_native.normalize_batch(batch))


@pytest.mark.parametrize("hw", [(120, 90), (90, 120), (224, 224), (300, 200)])
def test_preprocess_matches_jax(hw):
    """padding_and_resize, flip_sample, random_rescale (with and without the
    random position, one seed), the normalizations and the handedness
    vector. Bound: images within one uint8 level (measured: equal), arrays
    equal."""
    import random

    rng = np.random.RandomState(hw[0])
    img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    j2 = np.concatenate([rng.rand(42, 2) * 90, np.ones((42, 1))], 1).astype(np.float32)
    ours, jo = TP.padding_and_resize(img, j2, 224)
    ref, jr = JD.preprocess.padding_and_resize(img, j2, 224)
    assert np.abs(ours.astype(int) - ref).max() <= 1
    np.testing.assert_array_equal(jo, jr)
    args = (ours, np.ones(2, np.float32), jo, rng.randn(42, 4).astype(np.float32), rng.randn(96).astype(np.float32),
            rng.randn(20).astype(np.float32), np.asarray([1.0, 0.0], np.float32))
    for a, b in zip(TP.flip_sample(*args), JD.preprocess.flip_sample(*args)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for pos in (False, True):
        (oi, oj), (ri, rj) = (
            mod.random_rescale(ours, jo, random.Random(11), 224, use_random_position=pos)
            for mod in (TP, JD.preprocess)
        )
        assert np.abs(oi.astype(int) - ri).max() <= 1
        np.testing.assert_array_equal(oj, rj)
    np.testing.assert_array_equal(TP.normalize_joints_2d(jo, 224), JD.preprocess.normalize_joints_2d(jo, 224))
    np.testing.assert_array_equal(TP.normalize_image(ours), JD.preprocess.normalize_image(ours))
    for hand in ("right", "left", "interacting"):
        np.testing.assert_array_equal(TP.hand_type_str2array(hand), JD.preprocess.hand_type_str2array(hand))


# ---------------------------------------------------------------------------
# datasets


def _compare_items(ours, ref, image_tol=0.0, joints_tol=0.0):
    assert set(ours) == set(ref)
    for key in ref:
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.shape == b.shape and a.dtype == b.dtype, (key, a.shape, b.shape, a.dtype, b.dtype)
        tol = image_tol if key == "img" else joints_tol if key in ("joints_2d", "init_joints_2d") else 0.0
        if tol:
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


def _datasets(kind, corpus, **cfg):
    jcfg = JD.DataConfig(data_root=corpus, batch_size=4, **cfg)
    tcfg = TD.DataConfig(data_root=corpus, batch_size=4, **cfg)
    j, t = getattr(JD, kind)(jcfg, seed=3), getattr(TD, kind)(tcfg, seed=3)
    j.load_data()
    t.load_data()
    assert len(j) == len(t) and j.num_add == t.num_add
    assert [a["img_path"] for a in j.data_list] == [a["img_path"] for a in t.data_list]
    return j, t


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_flip_rescale_position"])
def test_baseline_dataset_matches_jax(corpus, train):
    """Every item, in order (one augmentation RNG stream per package, seed 3).
    Eval pads 6 samples to 8 (batch 4). Bound: images within one uint8 level,
    the rest equal."""
    aug = dict(is_train=True, use_random_flip=True, use_random_rescale=True, use_random_position=True) if train else {}
    j, t = _datasets("BaselineDataset", corpus, anno_path="anno.pkl", input_size=64, **aug)
    assert t.num_add == (0 if train else 2)
    flips = 0
    for i in range(len(j)):
        ref, ours = j[i], t[i]
        _compare_items(ours, ref, image_tol=LEVEL + 1e-6)
        flips += int(ours["do_flip"])
    assert flips >= 2  # the left-only samples, at least


@pytest.mark.parametrize(
    "kind,cfg",
    [
        ("OPTDataset", dict(anno_path="anno.pkl")),
        ("MLPDataset", dict(anno_path="anno.pkl")),
        ("MLPDataset", dict(anno_path="anno.pkl", is_train=True, use_opt_params=True, opt_params_path="opt_pgt.pkl")),
        ("MLPDataset", dict(anno_path="anno_missing.pkl", is_train=True, opt_params_path="opt_pgt.pkl")),
    ],
    ids=["opt", "mlp", "mlp_use_opt_params", "mlp_pseudo_gt_fallback"],
)
def test_prediction_datasets_match_jax(corpus, kind, cfg):
    """OPT and MLP items through the native letterbox. Bound: images
    bit-equal, 2D joints within 1e-6 (the kernel's float32 ratio), the rest
    equal."""
    assert jax_native.available()
    j, t = _datasets(kind, corpus, pred_path="pred.pkl", input_size=224, **cfg)
    for i in range(len(j)):
        _compare_items(t[i], j[i], joints_tol=1e-6)
    if cfg.get("use_opt_params"):
        assert np.all(t[0]["mano_params_weight"] == 1.0) and t[0]["hand_trans"][0, 3] == 1.0
    if cfg["anno_path"] == "anno_missing.pkl":
        assert t[1]["mano_params_weight"][1] == 1.0  # the missing left hand took the pseudo-GT


@pytest.mark.parametrize(
    "n,bs,shuffle,rank,world,drop",
    [(10, 3, False, 0, 1, False), (10, 3, True, 0, 1, True), (11, 2, True, 1, 3, False), (11, 4, True, 2, 3, True)],
)
def test_batch_loader_matches_jax(n, bs, shuffle, rank, world, drop):
    """Index order (shuffle by RandomState(seed + epoch), the rank stride
    after padding, drop_last), length and collated batches over two epochs,
    with and without the prefetch thread. Bound: equal."""

    class Items:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"i": np.asarray(i, np.int32), "x": np.full((2,), i, np.float32)}

    for prefetch in (0, 2):
        kw = dict(rank=rank, world_size=world, shuffle=shuffle, drop_last=drop, prefetch=prefetch, seed=5)
        jl, tl = JD.BatchLoader(Items(), bs, **kw), TD.BatchLoader(Items(), bs, **kw)
        assert len(jl) == len(tl)
        for epoch in (1, 2):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            np.testing.assert_array_equal(tl._indices(), jl._indices())
            jb, tb = list(jl), list(tl)
            assert len(jb) == len(tb)
            for a, b in zip(tb, jb):
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k])


def test_batch_loader_raises_dataset_errors():
    """A dataset error inside the prefetch thread reaches the consumer."""

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("sample 2 is broken")
            return {"i": np.asarray(i)}

    with pytest.raises(KeyError, match="sample 2"):
        list(TD.BatchLoader(Broken(), 2, prefetch=2))


def test_compose_and_directory_annotation_match_jax(corpus):
    """ComposeDataset over two baseline datasets (length, names, num_add,
    items) and load_annotation of an image directory. Bound: equal."""
    def members(pkg):
        out = []
        for anno in ("anno.pkl", "anno_missing.pkl"):
            ds = pkg.BaselineDataset(pkg.DataConfig(data_root=corpus, anno_path=anno, batch_size=4, input_size=32))
            ds.load_data()
            out.append(ds)
        return pkg.ComposeDataset(out)

    j, t = members(JD), members(TD)
    assert (len(t), t.num_add, t.name) == (len(j), j.num_add, j.name)
    assert [a["img_path"] for a in t.data_list] == [a["img_path"] for a in j.data_list]
    for i in (0, 7, len(j) - 1):
        _compare_items(t[i], j[i], image_tol=LEVEL + 1e-6)
    assert TD.load_annotation(corpus, "hand26m/image") == JD.load_annotation(corpus, "hand26m/image")
    assert io_utils.get_all_files(corpus, ".png", "name") == jax_io.get_all_files(corpus, ".png", "name")
    fresh = io_utils.renew_dir(osp.join(corpus, "renewed"))
    assert osp.isdir(fresh) and not os.listdir(fresh)


# ---------------------------------------------------------------------------
# MANO pkl


@pytest.mark.parametrize("buggy", [False, True], ids=["healthy", "buggy_left_shapedirs"])
def test_mano_pkl_matches_jax(tmp_path, buggy):
    """The fake MANO pkls of tests/test_mano_loader.py through both loaders:
    every array (float32), the Morton face order and hands_mean equal; with
    the buggy left shapedirs both negate the left x row."""
    sd = np.random.RandomState(1).randn(778, 3, 10) * 0.001 if buggy else None
    _write_fake_mano(str(tmp_path / "MANO_RIGHT.pkl"), buggy_left_shapedirs=sd)
    _write_fake_mano(str(tmp_path / "MANO_LEFT.pkl"), buggy_left_shapedirs=sd)
    ours, ref = TML.load_mano_pair(str(tmp_path), device="cpu"), JML.load_mano_pair(str(tmp_path))
    for hand in ("right", "left"):
        (tm, tmean), (jm, jmean) = ours[hand], ref[hand]
        for f in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "faces"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f"{hand} {f}")
        assert tm.is_rhand == jm.is_rhand
        np.testing.assert_array_equal(tmean, jmean)
    if buggy:
        np.testing.assert_array_equal(ours["left"][0].shapedirs[:, 0].numpy(), -ours["right"][0].shapedirs[:, 0].numpy())


# ---------------------------------------------------------------------------
# torchvision ResNet import


def _torchvision_resnet18_state(seed=0):
    """A seeded torchvision-layout ResNet-18 state dict: the backbone's keys
    (torchvision names), num_batches_tracked, and the classifier ``fc``."""
    rng = np.random.RandomState(seed)
    backbone = InterHandEncoder("resnet18").main_encoder
    state = {}
    for k, v in backbone.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = torch.tensor(3)
        elif k.endswith("running_var"):
            state[k] = torch.tensor(rng.rand(*v.shape).astype(np.float32) + 0.5)
        else:
            state[k] = torch.tensor(rng.randn(*v.shape).astype(np.float32) * 0.1)
    state["fc.weight"] = torch.tensor(rng.randn(1000, 512).astype(np.float32))
    state["fc.bias"] = torch.tensor(rng.randn(1000).astype(np.float32))
    return state


def test_import_torch_resnet_matches_jax(tmp_path):
    """The JAX importer onto flax variables (shapes from jax.eval_shape, no
    compile), carried over by convert.encoder_from_jax, against the port's
    importer onto the port's backbone: the state dicts equal; ``fc.*`` and
    ``num_batches_tracked`` are skipped; an unknown key raises only under
    strict; a .pth path loads the same."""
    state = _torchvision_resnet18_state()
    enc = FlaxEncoder(arch="resnet18")
    shapes = jax.eval_shape(enc.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros(122))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    variables = {"params": dict(variables["params"]), "batch_stats": dict(variables["batch_stats"])}
    params, stats = JCK.import_torch_resnet(
        state, variables["params"]["main_encoder"], variables["batch_stats"]["main_encoder"], strict=True
    )
    variables["params"]["main_encoder"], variables["batch_stats"]["main_encoder"] = params, stats
    ref = convert.encoder_from_jax(variables, arch="resnet18", device="cpu").main_encoder.state_dict()

    backbone = InterHandEncoder("resnet18").main_encoder
    ours = TCK.import_torch_resnet(state, backbone.state_dict(), strict=True)
    assert set(ours) == set(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    path = str(tmp_path / "resnet18.pth")
    torch.save(state, path)
    from_file = TCK.import_torch_resnet(path, backbone.state_dict())
    assert all(torch.equal(from_file[k], ours[k]) for k in ours)

    extra = dict(state, **{"layer9.0.conv1.weight": torch.zeros(1)})
    assert all(torch.equal(a, b) for a, b in zip(TCK.import_torch_resnet(extra, backbone.state_dict()).values(), ours.values()))
    with pytest.raises(KeyError, match="layer9"):
        TCK.import_torch_resnet(extra, backbone.state_dict(), strict=True)
    with pytest.raises(ValueError, match="does not fit"):
        TCK.import_torch_resnet(dict(state, **{"fc1.bias": torch.zeros(3)}), backbone.state_dict())


def test_png_unfilter_rejects_bad_filter():
    rows = np.zeros((2, 1 + 6), np.uint8)
    rows[1, 0] = 9
    with pytest.raises(ValueError, match="unknown filter type 9"):
        native.png_unfilter(rows.tobytes(), 2, 6, 3)
    with pytest.raises(ValueError, match="expected"):
        native.png_unfilter(rows.tobytes()[:-1], 2, 6, 3)


def test_datasets_refuse_unported_augmentations(corpus):
    for flag in ("use_random_rotation", "use_color_jittering", "use_motion_blur"):
        cfg = dataclasses.replace(TD.DataConfig(data_root=corpus, anno_path="anno.pkl"), **{flag: True})
        with pytest.raises(NotImplementedError, match=flag):
            TD.BaselineDataset(cfg)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """Where the JAX package falls back to cv2 when its native build fails,
    the port raises: without g++, and with g++'s output when it fails."""
    from ihmr_tpu_torch import build

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setitem(build.HOST_SOURCES, "broken", str(bad))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building .*broken.cpp failed"):
        build.load_host_library("broken")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.load_host_library("broken")
