"""The port's native IO library and its loaders' native paths against the
JAX package's native path, on the CPU.

``otpose_tpu_torch/data/native.py`` builds ``csrc/otpose_io.cpp`` (a copy of
``native/otpose_io.cpp``) with the JAX package's Makefile flags, so every
function is held bit for bit: the JPEG decode (also against the committed
fixture's libjpeg decode), the warp with normalisation and the gaussian
targets on inputs made from a seed with numpy; the host ``Loader`` with
``native_host`` and ``DeviceLoader``'s native decode (both modes, eval and
train) against the JAX loaders with their library on: every raw sample
bit-equal, batches to 1e-6 (crops: the same cv2 warp of the same pixels,
then the normalisation) or 1e-5 (full: the warp's f32 sums in two
frameworks), targets to 1e-6.  Then the decoder choice, the header reader
of ``data/nvjpeg.py`` and the reasons given when the library cannot build.
"""

import copy
import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

from otpose_tpu.data import native as jax_native
from otpose_tpu.data.device_loader import DeviceLoader as JaxDeviceLoader
from otpose_tpu.data.loader import Loader as JaxLoader
from otpose_tpu.data.posetrack import PoseTrackDataset as JaxDataset
from otpose_tpu.utils.testing import tiny_otpose_cfg as jax_tiny_cfg
from otpose_tpu_torch.data import describe_loader, make_loader
from otpose_tpu_torch.data import native
from otpose_tpu_torch.data import nvjpeg
from otpose_tpu_torch.data.device_loader import DeviceLoader
from otpose_tpu_torch.data.loader import Loader
from otpose_tpu_torch.data.posetrack import PoseTrackDataset
from otpose_tpu_torch.data.synthetic import ArrayFramesDataset
from otpose_tpu_torch.data.synthetic import make_synthetic_posetrack as make_array_posetrack
from otpose_tpu_torch.ops.affine import get_affine_transform, invert_affine
from otpose_tpu_torch.utils.testing import tiny_otpose_cfg

from tests.helpers.synthetic_data import make_synthetic_posetrack as make_jpg_posetrack
from tests.helpers.torch_port import one_torch_thread  # noqa: F401  (fixture)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(ROOT, "tests", "fixtures", "jpeg")
FIXTURE_NAMES = tuple(f"frame_{i:03d}" for i in range(5)) + ("odd_444", "grey", "odd_422",
                                                               "small_440")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", autouse=True)
def _both_libraries():
    if not jax_native.is_available():
        pytest.skip("the JAX package's native/libotpose_io.so does not load here")
    assert native.is_available(), native.reason()


def test_source_is_the_jax_package_s():
    """The port's copy differs from native/otpose_io.cpp in its header
    comment only."""
    def body(path):
        text = open(path).read()
        return text[text.index("#include <algorithm>"):]

    assert body(native.SOURCE) == body(osp.join(ROOT, "native", "otpose_io.cpp"))
    assert native.CXX_FLAGS == ("-O3", "-march=native", "-fopenmp", "-fPIC", "-Wall",
                                "-std=c++17")


def _fixture_paths():
    return [osp.join(FIXTURE, n + ".jpg") for n in FIXTURE_NAMES]


def test_decode_equals_the_jax_library_and_the_fixture():
    paths = _fixture_paths()
    got, hs, ws, fails = native.decode_jpeg_batch(paths, 720, 1280)
    want, jhs, jws, jfails = jax_native.decode_jpeg_batch(paths, 720, 1280)
    assert fails == jfails == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hs, jhs)
    np.testing.assert_array_equal(ws, jws)
    ref = np.load(osp.join(FIXTURE, "decoded.npz"))
    for i, name in enumerate(FIXTURE_NAMES):
        np.testing.assert_array_equal(got[i, :hs[i], :ws[i]], ref[name], err_msg=name)
        assert not got[i, hs[i]:].any() and not got[i, :, ws[i]:].any()


@pytest.mark.parametrize("case", ["missing", "too_large", "not_a_jpeg"])
def test_decode_failures_equal_the_jax_library(tmp_path, case):
    good = _fixture_paths()[5]          # 333x251
    bad = {"missing": str(tmp_path / "nope.jpg"), "too_large": _fixture_paths()[0]}
    if case == "not_a_jpeg":
        bad[case] = str(tmp_path / "text.jpg")
        open(bad[case], "w").write("not a jpeg")
    paths = [good, bad[case], good]
    got = native.decode_jpeg_batch(paths, 300, 400)
    want = jax_native.decode_jpeg_batch(paths, 300, 400)
    assert got[3] == want[3] == 1
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[1][1] == got[2][1] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("out_hw", [(24, 32), (384, 288)])
def test_warp_normalize_is_bit_equal(seed, out_hw):
    rng = np.random.RandomState(seed)
    n = 5
    imgs = rng.randint(0, 256, (n, 90, 120, 3)).astype(np.uint8)
    hs = rng.randint(40, 91, n).astype(np.int32)
    ws = rng.randint(60, 121, n).astype(np.int32)
    inv = []
    for i in range(n):
        center = rng.uniform([10, 10], [ws[i] - 10, hs[i] - 10])
        trans = get_affine_transform(center, rng.uniform(0.1, 0.5, 2), rng.uniform(-40, 40),
                                     np.array(out_hw[::-1]))
        inv.append(invert_affine(trans))
    inv = np.stack(inv)
    got = native.warp_normalize_batch(imgs, hs, ws, inv, *out_hw)
    want = jax_native.warp_normalize_batch(imgs, hs, ws, inv, *out_hw)
    assert got.shape == (n, *out_hw, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma", [2.0, 3.0])
def test_generate_targets_is_bit_equal(sigma):
    rng = np.random.RandomState(int(sigma))
    joints = rng.uniform(-30, 320, (4, 17, 2))
    vis = (rng.rand(4, 17) > 0.3).astype(np.float32)
    got = native.generate_targets_batch(joints, vis, sigma, 4.0, 4.0, 72, 96)
    want = jax_native.generate_targets_batch(joints, vis, sigma, 4.0, 4.0, 72, 96)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].max() == 1.0 and (got[1] == 0).any()


@pytest.fixture(scope="module")
def jpg_tree(tmp_path_factory):
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("native_io")
    return make_jpg_posetrack(str(root), num_videos=2, frames_per_video=4, people_per_frame=2,
                              img_w=128, img_h=96)


def _fill(cfg, dirs, train=False):
    json_dir, img_dir, annot_dir = dirs
    cfg.DATASET.JSON_DIR = json_dir
    cfg.DATASET.IMG_DIR = img_dir
    cfg.DATASET.TEST_IMG_DIR = img_dir
    cfg.DATASET.COLOR_RGB = True
    cfg.VAL.ANNOT_DIR = annot_dir
    cfg.VAL.USE_GT_BBOX = True
    if train:
        cfg.TRAIN.PROB_HALF_BODY = 0.0
        cfg.TRAIN.ROT_FACTOR = 30
    return cfg


def _pair(dirs, phase):
    train = phase == "train"
    return (JaxDataset(_fill(jax_tiny_cfg(), dirs, train), phase),
            PoseTrackDataset(_fill(tiny_otpose_cfg(), dirs, train), phase))


def _same(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, str):
        assert a == b, what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("phase", ["validate", "train"])
def test_native_host_samples_are_bit_equal(jpg_tree, phase):
    want, got = _pair(jpg_tree, phase)
    for i in range(len(got)):
        rng_seed = 100 + i
        a = want.get_sample_host(i, rng=np.random.RandomState(rng_seed), native_ok=True)
        b = got.get_sample_host(i, rng=np.random.RandomState(rng_seed), native_ok=True)
        _same(a, b, f"sample {i}")


def test_native_host_path_differs_from_cv2_by_a_uint8_step(jpg_tree):
    _, got = _pair(jpg_tree, "validate")
    a = got.get_sample_host(0, native_ok=True)["inputs"]
    b = got.get_sample_host(0, native_ok=False)["inputs"]
    step = 1 / (255 * 0.224)        # the largest channel's uint8 step, normalised
    assert 0 < np.abs(a - b).max() <= step + 1e-6


def test_native_train_samples_are_the_cv2_samples_within_a_uint8_step(jpg_tree):
    """The train CLI's host path (rotation, flips, scale) with the native
    library and without it, for the same index and seed: the crops within
    each channel's uint8 step (cv2 rounds its fixed-point warp to uint8, the
    library keeps its float bilinear sum, so the two are about half a step
    apart), the targets to 1e-6 of their peak of 1 (f64 ``exp`` rounded
    once against the JAX package's f32 gaussian), the weights and the metas
    equal."""
    _, got = _pair(jpg_tree, "train")
    step = 1 / (255 * np.array([0.229, 0.224, 0.225], np.float32))
    rotated = flipped = 0
    for i in range(len(got)):
        a = got.get_sample_host(i, rng=np.random.RandomState(200 + i), native_ok=True)
        b = got.get_sample_host(i, rng=np.random.RandomState(200 + i), native_ok=False)
        gap = np.abs(a["inputs"] - b["inputs"]).reshape(*a["inputs"].shape[:2], 5, 3)
        assert (gap <= step + 1e-6).all(), (i, float((gap / step).max()))
        assert gap.max() > 0
        np.testing.assert_allclose(a["target"], b["target"], rtol=0, atol=1e-6)
        assert a["target"].max() == b["target"].max() == 1.0
        _same(a["target_weight"], b["target_weight"], f"weight {i}")
        _same(a["margin"], b["margin"], f"margin {i}")
        _same(a["meta"], b["meta"], f"meta {i}")
        rotated += a["meta"]["rotation"] != 0
        flipped += a["meta"]["center"][0] != got.data[i]["center"][0]
    assert rotated and flipped, (rotated, flipped)


@pytest.mark.parametrize("phase", ["validate", "train"])
def test_loader_native_host_is_bit_equal(jpg_tree, phase):
    want_ds, got_ds = _pair(jpg_tree, phase)
    kw = dict(num_workers=2, shuffle=True, drop_last=False, seed=11)
    want_l, got_l = JaxLoader(want_ds, 3, **kw), Loader(got_ds, 3, **kw)
    for loader in (want_l, got_l):
        loader.set_epoch(2)
    assert want_l.native_host and got_l.native_host and got_l.host_warp == "native"
    want, got = list(want_l), list(got_l)
    assert len(got) == len(want) == len(got_l) > 1
    for (wb, wm), (gb, gm) in zip(want, got):
        _same(wb, gb, "batch")
        _same(wm, gm, "metas")


def _raw(loader, idx, seed=5):
    return loader._load_raw_sample(idx, np.random.RandomState(seed))


@pytest.mark.parametrize("mode", ["crops", "full"])
@pytest.mark.parametrize("phase", ["validate", "train"])
def test_device_loader_native_decode_matches_jax(jpg_tree, mode, phase):
    want_ds, got_ds = _pair(jpg_tree, phase)
    kw = dict(shuffle=False, num_workers=2, seed=7, max_frame_hw=(128, 160), mode=mode)
    want_l = JaxDeviceLoader(want_ds, 4, **kw)
    got_l = DeviceLoader(got_ds, 4, device="cpu", **kw)
    assert got_l.decoder == "native"
    for i in range(len(got_ds)):
        a, b = _raw(want_l, i, seed=i), _raw(got_l, i, seed=i)
        for k in ("frames", "inv", "joints", "vis", "margin"):
            if a[k] is None:
                assert b[k] is None, k
            else:
                np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
        _same(a["meta"], b["meta"], "meta")
    for loader in (want_l, got_l):
        loader.set_epoch(1)
    want, got = list(want_l), list(got_l)
    assert len(got) == len(want) > 1
    tol = 1e-6 if mode == "crops" else 1e-5
    for (wb, _), (gb, _) in zip(want, got):
        np.testing.assert_allclose(gb["inputs"].numpy(), np.asarray(wb["inputs"]), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(gb["target"].numpy(), np.asarray(wb["target"]), rtol=0,
                                   atol=1e-6)
        for k in ("target_weight", "margin"):
            np.testing.assert_array_equal(gb[k].numpy(), np.asarray(wb[k]), err_msg=k)


def test_device_loader_native_decode_honours_color_rgb(jpg_tree):
    want_ds, got_ds = _pair(jpg_tree, "validate")
    for ds in (want_ds, got_ds):
        ds.color_rgb = False
    kw = dict(shuffle=False, num_workers=1, max_frame_hw=(128, 160), mode="full")
    a = _raw(JaxDeviceLoader(want_ds, 2, **kw), 0)["frames"]
    b = _raw(DeviceLoader(got_ds, 2, device="cpu", **kw), 0)["frames"]
    np.testing.assert_array_equal(b, a)
    rgb = copy.copy(got_ds)
    rgb.color_rgb = True
    c = _raw(DeviceLoader(rgb, 2, device="cpu", **kw), 0)["frames"]
    np.testing.assert_array_equal(c, b[..., ::-1])


def test_device_loader_native_decode_failure_names_files_and_buffer(jpg_tree, tmp_path):
    _, got_ds = _pair(jpg_tree, "validate")
    loader = DeviceLoader(got_ds, 2, device="cpu", max_frame_hw=(64, 64), mode="full")
    with pytest.raises(ValueError, match=r"max_frame_hw") as err:
        _raw(loader, 0)
    assert got_ds.data[0]["image"] in str(err.value)
    broken = copy.copy(got_ds)
    broken.data = copy.deepcopy(got_ds.data)
    corrupt = str(tmp_path / "00000001.jpg")
    open(corrupt, "wb").write(b"\xff\xd8garbage")
    broken.data[0]["image"] = corrupt
    with pytest.raises(ValueError, match="decode failure") as err:
        _raw(DeviceLoader(broken, 2, device="cpu", max_frame_hw=(128, 160), mode="full"), 0)
    assert corrupt in str(err.value)


def test_decoder_choice(jpg_tree, tmp_path, monkeypatch):
    _, got_ds = _pair(jpg_tree, "validate")
    kw = dict(max_frame_hw=(128, 160))
    assert DeviceLoader(got_ds, 2, device="cpu", mode="full", **kw).decoder == "native"
    assert DeviceLoader(got_ds, 2, device="cpu", mode="crops", **kw).decoder == "native"
    dirs = make_array_posetrack(str(tmp_path), num_videos=1, frames_per_video=3)
    arrays = ArrayFramesDataset(_fill(tiny_otpose_cfg(), dirs), "validate")
    assert DeviceLoader(arrays, 2, device="cpu", mode="full", **kw).decoder == "read_frame"
    assert Loader(arrays, 2).host_warp == "warp_frame"
    # on a CUDA device in full mode nvJPEG is taken when it builds (no card
    # here: the loader is only made, never iterated)
    monkeypatch.setattr(nvjpeg, "is_available", lambda: True)
    monkeypatch.setattr(nvjpeg, "hardware_backend", lambda: True)
    full = DeviceLoader(got_ds, 2, device="cuda", mode="full", **kw)
    assert full.decoder == "nvjpeg"
    assert "nvjpeg (hardware backend)" in describe_loader(full)
    assert DeviceLoader(got_ds, 2, device="cuda", mode="crops", **kw).decoder == "native"
    assert DeviceLoader(arrays, 2, device="cuda", mode="full", **kw).decoder == "read_frame"
    monkeypatch.setattr(native, "is_available", lambda: False)
    monkeypatch.setattr(native, "reason", lambda: "jpeglib.h is not on g++'s include path")
    off = DeviceLoader(got_ds, 2, device="cuda", mode="crops", **kw)
    assert off.decoder == "read_frame" and "jpeglib.h" in describe_loader(off)
    assert Loader(got_ds, 2).host_warp == "warp_frame"
    cfg = copy.deepcopy(got_ds.cfg)
    cfg.TPU.DEVICE_PREPROCESS = "off"
    host = make_loader(cfg, got_ds, 2, shuffle=False, device="cpu")
    assert host.native_host and describe_loader(host).startswith("Loader (host")


def test_jpeg_header_sizes():
    ref = np.load(osp.join(FIXTURE, "decoded.npz"))
    for name, path in zip(FIXTURE_NAMES, _fixture_paths()):
        with open(path, "rb") as fh:
            assert nvjpeg.jpeg_size(fh.read()) == ref[name].shape[:2], name
    for bad in (b"", b"GIF89a", b"\xff\xd8\xff\xe0\x00\x10JFIF\x00"):
        with pytest.raises(ValueError):
            nvjpeg.jpeg_size(bad)


@pytest.mark.parametrize("stem", ["frame_000", "odd_444", "grey", "odd_422"])
def test_conversion_plain_version_reproduces_libjpeg(stem):
    """``nvjpeg.ycc_to_rgb`` (the plain version of the card's conversion
    kernel) on libjpeg's own planes gives libjpeg's RGB bit for bit: 4:2:0
    and 4:2:2 (fancy upsampling, then colour), 4:4:4 and grey."""
    planes = np.load(osp.join(FIXTURE, "planes.npz"))
    ref = np.load(osp.join(FIXTURE, "decoded.npz"))
    args = [torch.from_numpy(planes[f"{stem}_{k}"]) if f"{stem}_{k}" in planes else None
            for k in ("y", "cb", "cr")]
    np.testing.assert_array_equal(nvjpeg.ycc_to_rgb(*args).numpy(), ref[stem])


def test_nvjpeg_decodes_on_a_cuda_device_only():
    with pytest.raises(ValueError, match="CUDA"):
        nvjpeg.decode_jpeg_batch_device(_fixture_paths()[:1], 720, 1280, device="cpu")


def test_nvjpeg_refusals_name_the_file():
    """The C side's codes for a frame too large and for a chroma sampling
    the conversion kernel lacks (4:4:0, 4:1:1) raise naming the file."""
    paths = ["a.jpg", "b.jpg"]
    with pytest.raises(ValueError, match="chroma sampling") as err:
        nvjpeg._raise(None, nvjpeg.UNSUPPORTED_SAMPLING, 1, paths, [0, 0], [0, 0], 9, 9)
    assert "b.jpg" in str(err.value)
    with pytest.raises(ValueError, match="max_frame_hw") as err:
        nvjpeg._raise(None, nvjpeg.TOO_LARGE, 0, paths, [20, 0], [30, 0], 9, 9)
    assert "a.jpg" in str(err.value) and "(20, 30)" in str(err.value)


def test_no_quiet_fallback_from_nvjpeg(jpg_tree, monkeypatch):
    """On a CUDA device, frames decoded whole (full mode, generate_boxes)
    take nvJPEG or raise with its reason; the host decodes only for a CPU
    device or crops mode."""
    from otpose_tpu_torch.data.decoders import choose_decoder
    from otpose_tpu_torch.tools import generate_boxes as gb

    _, got_ds = _pair(jpg_tree, "validate")
    monkeypatch.setattr(nvjpeg, "is_available", lambda: False)
    monkeypatch.setattr(nvjpeg, "reason", lambda: "nvcc failed on jpeg_nv.cu")
    for make in (lambda: DeviceLoader(got_ds, 2, device="cuda", mode="full",
                                      max_frame_hw=(128, 160)),
                 lambda: gb.frame_reader("cuda"), lambda: choose_decoder("cuda:0")):
        with pytest.raises(RuntimeError, match="nvcc failed on jpeg_nv.cu"):
            make()
    assert DeviceLoader(got_ds, 2, device="cuda", mode="crops").decoder == "native"
    assert choose_decoder("cpu") == ("native", "native")
    assert choose_decoder("cuda", "crops")[0] == "native"
    with pytest.raises(ValueError, match="mode"):
        choose_decoder("cpu", "off")


def test_build_reasons(tmp_path, monkeypatch):
    """Without g++, or without jpeglib.h on its include path, the build
    raises with the reason ``native.reason()`` keeps."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.build()
    monkeypatch.undo()
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    src = tmp_path / "probe.cpp"
    src.write_text("#include <jpeglib.h>\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-nostdinc",))
    with pytest.raises(RuntimeError, match="jpeglib.h is not on g\\+\\+'s include path"):
        native.build()
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


@pytest.mark.parametrize("phase", ["validate", "train"])
def test_nvjpeg_path_with_libjpeg_in_its_place_equals_the_native_path(jpg_tree, phase,
                                                                      monkeypatch):
    """``DeviceLoader``'s nvJPEG path (file bytes and header sizes on the
    host, one staging tensor a batch, the flip on the device, blur and
    rotation on the host) with the card's decode replaced by the native
    library's writing into the same staging tensor: every batch equals the
    native decoder's bit for bit, train augmentation included."""
    _, got_ds = _pair(jpg_tree, phase)
    calls = []

    def fake_decode(paths, max_h, max_w, device="cuda", out=None, backend="auto", data=None):
        assert out is not None and out.shape == (len(paths), max_h, max_w, 3)
        assert data is not None and len(data) == len(paths)
        frames, hs, ws, fails = native.decode_jpeg_batch(paths, max_h, max_w)
        assert fails == 0
        out.copy_(torch.from_numpy(frames))
        calls.append(len(paths))
        return nvjpeg.Decoded(out, list(hs), list(ws), ["default"] * len(paths),
                              ["4:2:0"] * len(paths))

    monkeypatch.setattr(nvjpeg, "decode_jpeg_batch_device", fake_decode)
    kw = dict(shuffle=True, num_workers=2, seed=3, max_frame_hw=(128, 160), mode="full",
              device="cpu")
    want_l, got_l = DeviceLoader(got_ds, 3, **kw), DeviceLoader(got_ds, 3, **kw)
    got_l.decoder = "nvjpeg"
    for loader in (want_l, got_l):
        loader.set_epoch(4)
    want, got = list(want_l), list(got_l)
    assert len(got) == len(want) > 1 and calls == [15] * (len(got) - 1) + [5 * (len(got_ds) % 3
                                                                              or 3)]
    for (wb, wm), (gb, gm) in zip(want, got):
        for k in wb:
            assert torch.equal(gb[k], wb[k]), k
        _same(wm, gm, "metas")
    if phase == "train":
        metas = [m for _, ms in got for m in ms]
        assert any(m["rotation"] != 0 for m in metas)
