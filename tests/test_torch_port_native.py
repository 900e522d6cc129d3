"""The port's native decoder (``aldi_tpu_torch/data/native.py``,
``aldi_tpu_torch/csrc/native_decode.cpp``) against the JAX package's
``aldi_native`` extension and against its plain numpy version, on the CPU.

The core is built here twice: with its codecs (libjpeg and libpng decode,
as in ``aldi_native``: the loaders' native branch) and without them (PIL
decodes and the core resizes: no branch of the loaders, kept to time the
core's resize where the codecs are missing). Both are held bitwise against
``aldi_native`` where their decodes agree, and the core without codecs
against the plain version everywhere. Then ``transform_record`` and the
loaders on the native branch against the JAX package's native branch,
failures (a missing or truncated file, codecs that do not link and a core
that does not build: the PIL branch, as the JAX package without its
extension), and eight threads building the core at once.
"""

import os
import sys
import threading

import numpy as np
import pytest
from PIL import Image

import aldi_tpu.data.transforms as jax_transforms
import aldi_tpu_torch.data.transforms as port_transforms
from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.data.loader import StreamLoader as JaxStreamLoader
from aldi_tpu.data.loader import TestLoader as JaxTestLoader
from aldi_tpu.data.loader import WeakStrongLoader as JaxWeakStrongLoader
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.data import native
from aldi_tpu_torch.data.loader import (StreamLoader, TestLoader,
                                        WeakStrongLoader)
from aldi_tpu_torch.ops import _build
from tests.torch_port_common import (decoder_branch, loader_cfg,
                                     register_synthetic_both, tiny_cfg)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

H, W = 96, 128

# load_resize_pad's arguments after the path: short_edge, max_size,
# canvas_h, canvas_w, bgr, flip (the image is 96 x 128)
SETTINGS = {
    "scale 0.8": (77, 1000, 160, 160, True, False),
    "identity": (96, 1000, 160, 160, True, False),
    "scale 1.25": (120, 1000, 160, 224, True, False),
    "max_size cap": (120, 140, 160, 224, True, False),
    "flip": (77, 1000, 160, 160, True, True),
    "rgb": (120, 1000, 160, 224, False, False),
    "canvas smaller than the resize": (120, 1000, 90, 100, True, True),
}
# the images whose decode libpng/libjpeg and PIL agree on
SAME_DECODE = ("png rgb", "png gray", "png palette", "jpeg baseline",
               "jpeg progressive", "jpeg gray")
IMAGES = SAME_DECODE + ("png rgba", "png 16-bit")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Noise textures: a 0.8 downscale of them differs between the two
    resize filters by up to 90 levels, so a branch mix-up shows."""
    root = tmp_path_factory.mktemp("native_images")
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (H, W, 3), np.uint8)
    gray = rgb[..., 0]
    paths = {k: str(root / f"{k.replace(' ', '_')}.{k.split()[0]}")
             for k in IMAGES}
    Image.fromarray(rgb).save(paths["png rgb"])
    Image.fromarray(gray).save(paths["png gray"])
    Image.fromarray(rgb).convert("P").save(paths["png palette"])
    alpha = rng.integers(0, 256, (H, W, 1), np.uint8)
    Image.fromarray(np.concatenate([rgb, alpha], -1), "RGBA").save(
        paths["png rgba"])
    Image.fromarray(rng.integers(0, 65536, (H, W)).astype(np.uint16)).save(
        paths["png 16-bit"])
    Image.fromarray(rgb).save(paths["jpeg baseline"], quality=90)
    Image.fromarray(rgb).save(paths["jpeg progressive"], quality=90,
                              progressive=True)
    Image.fromarray(gray).save(paths["jpeg gray"], quality=90)
    assert Image.open(paths["png 16-bit"]).mode == "I;16"
    assert Image.open(paths["png palette"]).mode == "P"
    return paths


@pytest.fixture(scope="module")
def cores():
    """The core with its codecs and without them."""
    with_codecs, without = native.Core(codecs=True), native.Core(codecs=False)
    assert with_codecs.codecs and not without.codecs
    return {"codecs": with_codecs, "no codecs": without}


def max_abs(got, want):
    return int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())


def assert_same(got, want, what):
    """Equal (canvas, out_h, out_w, scale) tuples, the canvas bitwise."""
    assert got[1:] == want[1:], (what, got[1:], want[1:])
    assert got[0].dtype == np.uint8 and got[0].shape == want[0].shape, what
    err = max_abs(got[0], want[0])
    print(f"{what}: out {got[1:3]}, scale {got[3]:.6g}, max abs err {err}")
    np.testing.assert_array_equal(got[0], want[0], err_msg=what)


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("image", IMAGES)
def test_core_equals_aldi_native(images, cores, image, setting):
    """The core with its codecs is bitwise ``aldi_native`` on every image;
    the core without them (PIL decodes) where the decodes agree, and
    PIL's decode plus the same resize (the plain version) on RGBA and
    16-bit PNGs."""
    aldi_native = pytest.importorskip("aldi_native")
    path, args = images[image], SETTINGS[setting]
    want = aldi_native.load_resize_pad(path, *args)
    h, w = want[1:3]
    assert not want[0][h:].any() and not want[0][:, w:].any()
    assert_same(cores["codecs"].load_resize_pad(path, *args), want,
                f"{image}, {setting}: codecs")
    got = cores["no codecs"].load_resize_pad(path, *args)
    if image in SAME_DECODE:
        assert_same(got, want, f"{image}, {setting}: PIL decodes")
    else:
        print(f"{image}, {setting}: PIL's decode against libpng's, max abs "
              f"err {max_abs(got[0], want[0])}")
        assert_same(got, native.load_resize_pad_plain(path, *args),
                    f"{image}, {setting}: PIL decodes, against plain")


@pytest.mark.parametrize("image", SAME_DECODE)
def test_core_equals_plain(images, cores, image):
    """Both builds of the core against ``load_resize_pad_plain`` (numpy
    float32 in the core's order), bitwise, at every setting."""
    for setting, args in SETTINGS.items():
        want = native.load_resize_pad_plain(images[image], *args)
        for name, core in cores.items():
            assert_same(core.load_resize_pad(images[image], *args), want,
                        f"{image}, {setting}, {name}")


def test_native_differs_from_the_pil_resize(images):
    """The branches really differ on a downscaled texture: PIL's
    antialiased bilinear takes more taps than the core's two."""
    args = SETTINGS["scale 0.8"]
    got = native.load_resize_pad(images["png rgb"], *args)
    pil = Image.open(images["png rgb"]).convert("RGB").resize(
        (got[2], got[1]), Image.BILINEAR)
    want = np.asarray(pil)[:, :, ::-1]
    err = max_abs(got[0][:got[1], :got[2]], want)
    print(f"native against PIL's resize at 0.8: max abs err {err}")
    assert err > 20


def test_decoder_reports_native():
    assert native.decoder() == ("native",
                                "libjpeg and libpng decode in the core")


# ----------------------------------------------- transform_record and loaders
@pytest.fixture(scope="module")
def records(tmp_path_factory, images):
    """Records of noise images with gt boxes and precomputed proposals
    (the image's own, in its pixel coordinates)."""
    rng = np.random.default_rng(1)
    out = []
    for i, key in enumerate(("png rgb", "jpeg baseline", "png palette")):
        xy = rng.uniform(0, [W - 20, H - 20], (12, 2))
        wh = rng.uniform(4, 20, (12, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        out.append({
            "file_name": images[key], "image_id": i + 1, "height": H,
            "width": W,
            "annotations": [
                {"bbox": [float(x), float(y), float(bw), float(bh)],
                 "category_id": int(c), "iscrowd": 0, "area": 1.0}
                for (x, y), (bw, bh), c in zip(
                    xy[:3], wh[:3], rng.integers(0, 3, 3))],
            "proposal_boxes": boxes,
            "proposal_objectness_logits": rng.normal(
                size=12).astype(np.float32)})
    return out


TRANSFORMS = {
    "train": dict(min_sizes=[77, 96, 120], max_size=200),
    "train, crop (both take PIL)": dict(
        min_sizes=[77, 120], max_size=200,
        crop={"enabled": True, "type": "relative_range", "size": [0.6, 0.7]}),
    "train, canvas smaller than the resize": dict(
        min_sizes=[120], max_size=200, canvas=(90, 100)),
    "test": dict(min_sizes=[77], max_size=200, is_train=False),
}


def assert_equal_records(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=f"{what}/{k}")
        else:
            assert got[k] == v, (what, k)


@pytest.mark.parametrize("case", list(TRANSFORMS))
def test_transform_record_native_matches_jax(records, monkeypatch, case):
    """Images bitwise, boxes, sizes, scales and proposals exactly, for the
    same numpy seeds; without a crop and at a scale other than 1 the native
    branch's images differ from the PIL branch's."""
    decoder_branch(monkeypatch, "native")
    kw = dict(canvas=(160, 224), max_gt=4, proposal_topk=8)
    kw.update(TRANSFORMS[case])
    crop = "crop" in case
    differ, resized = 0, 0
    for seed in range(6):
        rec = records[seed % len(records)]
        got = port_transforms.transform_record(
            rec, np.random.default_rng(seed), **kw)
        want = jax_transforms.transform_record(
            rec, np.random.default_rng(seed), **kw)
        assert_equal_records(got, want, f"{case}, seed {seed}")
        with monkeypatch.context() as m:
            m.setattr(port_transforms, "_native", None)
            pil = port_transforms.transform_record(
                rec, np.random.default_rng(seed), **kw)
        differ += not np.array_equal(pil["image"], got["image"])
        resized += not crop and got["scale"] != 1.0
    print(f"{case}: 6 records equal; {differ} differ from the PIL branch, "
          f"{resized} resized without a crop")
    assert differ == resized and (crop or resized > 0)


def _loader_cfgs(names):
    cfgs = []
    for get_cfg in (port_get_cfg, jax_get_cfg):
        cfg = loader_cfg(tiny_cfg(get_cfg), names)
        cfg.DATASETS.BATCH_CONTENTS = ("labeled_strong", "unlabeled_strong")
        cfg.DATASETS.BATCH_RATIOS = (1, 1)
        cfg.SOLVER.IMS_PER_BATCH = 6
        cfg.INPUT.MIN_SIZE_TRAIN = (77, 96, 120)
        cfg.INPUT.MAX_SIZE_TRAIN = 160
        cfg.INPUT.MIN_SIZE_TEST = 77
        cfg.TPU.PREFETCH = 1
        cfgs.append(cfg)
    return cfgs


def test_loaders_on_the_native_branch_match_jax(tmp_path, monkeypatch):
    """``WeakStrongLoader`` (4 threads a stream) and ``TestLoader`` reach
    the core through ``apply_transform`` / ``transform_record``: their
    batches equal the JAX package's native branch's."""
    decoder_branch(monkeypatch, "native")
    names = register_synthetic_both(tmp_path, "port_native")
    cfg, jcfg = _loader_cfgs(names)
    got = WeakStrongLoader(cfg, (128, 160), seed=3, num_threads=4)
    want = JaxWeakStrongLoader(jcfg, (128, 160), seed=3, num_threads=4)
    for i in range(3):
        g, w = next(got), next(want)
        for s in ("labeled", "unlabeled"):
            assert_equal_records(g[s], w[s], f"batch {i} {s}")
    got = list(TestLoader(names["val"], cfg, (128, 160), batch_size=3))
    want = list(JaxTestLoader(names["val"], jcfg, (128, 160), batch_size=3))
    assert len(got) == len(want) == 2
    for (gb, gm), (wb, wm) in zip(got, want):
        assert_equal_records(gb, wb, "test batch")
        assert gm == wm
    print("3 training batches and 2 test batches equal")


# ----------------------------------------------------------------- failures
@pytest.fixture(scope="module")
def broken(tmp_path_factory, images):
    root = tmp_path_factory.mktemp("broken")
    data = open(images["png rgb"], "rb").read()
    truncated = root / "truncated.png"
    truncated.write_bytes(data[:len(data) // 2])
    return {"missing": str(root / "missing.png"),
            "truncated": str(truncated)}


@pytest.mark.parametrize("kind", ["missing", "truncated"])
def test_bad_files_raise_oserror(broken, cores, kind):
    """``OSError`` naming the path from both builds of the core, the
    module's ``load_resize_pad``, the plain version and ``aldi_native``."""
    aldi_native = pytest.importorskip("aldi_native")
    path, args = broken[kind], SETTINGS["identity"]
    with pytest.raises(OSError):
        aldi_native.load_resize_pad(path, *args)
    fns = {**{name: c.load_resize_pad for name, c in cores.items()},
           "load_resize_pad": native.load_resize_pad,
           "plain": native.load_resize_pad_plain}
    for name, fn in fns.items():
        with pytest.raises(OSError, match="failed to read/decode") as e:
            fn(path, *args)
        assert path in str(e.value), name
        print(f"{kind}, {name}: {e.value}")


@pytest.mark.parametrize("kind", ["missing", "truncated"])
def test_a_workers_oserror_reaches_the_consumer(broken, records,
                                                monkeypatch, kind):
    """A loader thread's ``OSError`` is raised by ``next()``, in both
    packages, on the native branch."""
    decoder_branch(monkeypatch, "native")
    recs = [dict(records[0], file_name=broken[kind], image_id=9)]
    cfgs = _loader_cfgs({"train": "", "unlabeled": "", "val": ""})
    for loader_cls, cfg in ((StreamLoader, cfgs[0]),
                            (JaxStreamLoader, cfgs[1])):
        cfg.MODEL.LOAD_PROPOSALS = False
        loader = loader_cls(recs, 2, cfg, (160, 224), seed=0, num_threads=2)
        with pytest.raises(OSError) as e:
            next(loader)
        print(f"{loader_cls.__module__}: {e.value}")


def test_threads_build_one_library(tmp_path, monkeypatch, images):
    """Eight threads that decode at once on an empty build directory build
    one library (the compiler runs once) and all return aldi_native's
    bits."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(native, "_state", {})
    runs = []
    real_cxx = _build.cxx

    def counting_cxx():
        runs.append(threading.get_ident())
        return real_cxx()

    monkeypatch.setattr(_build, "cxx", counting_cxx)
    args = SETTINGS["scale 0.8"]
    barrier = threading.Barrier(8)
    results, errors = [None] * 8, []

    def decode(i):
        try:
            barrier.wait(timeout=30)
            results[i] = native.load_resize_pad(images["png rgb"], *args)
        except Exception as e:  # reported below
            errors.append(e)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=decode, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    built = sorted(p.name for p in tmp_path.iterdir())
    print(f"compiler runs {len(runs)}; build directory {built}")
    assert len(runs) == 1 and len(built) == 1 and built[0].endswith(".so")
    for r in results[1:]:
        assert_same(r, results[0], "thread")
    aldi_native = pytest.importorskip("aldi_native")
    assert_same(results[0], aldi_native.load_resize_pad(images["png rgb"],
                                                        *args),
                "threads against aldi_native")


def test_decoder_falls_back_when_the_codecs_do_not_build(
        tmp_path, monkeypatch, records):
    """Without the codecs (a library that does not link) the loaders take
    the PIL branch, as the JAX package does where its extension does not
    build: ``decoder()`` says "pil" and names the link error, and
    ``transform_record`` equals the JAX package's with ``_native`` None,
    bitwise, though the core without its codecs still builds."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setattr(native, "CODEC_FLAGS",
                        (*native.CODEC_FLAGS, "-laldi_no_such_library"))
    name, why = native.decoder()
    print(f"decoder: {name} ({why})")
    assert name == "pil" and why.startswith("PIL decodes and resizes")
    assert "aldi_no_such_library" in why
    assert native.core() is None
    assert not native.Core(codecs=False).codecs
    monkeypatch.setattr(jax_transforms, "_native", None)
    kw = dict(TRANSFORMS["train"], canvas=(160, 224), max_gt=4,
              proposal_topk=8)
    for seed, rec in enumerate(records):
        assert_equal_records(
            port_transforms.transform_record(
                rec, np.random.default_rng(seed), **kw),
            jax_transforms.transform_record(
                rec, np.random.default_rng(seed), **kw), f"seed {seed}")


def test_decoder_reports_pil_when_the_build_fails(tmp_path, monkeypatch,
                                                  records):
    """A core that does not compile: ``decoder()`` is ("pil", the
    compiler's error), ``load_resize_pad`` raises, and ``transform_record``
    takes the PIL branch (equal to the JAX package's PIL branch)."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / f"{native.SOURCE}.cpp").write_text("int broken(void) { return }\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(native, "_state", {})
    name, why = native.decoder()
    print(f"decoder: {name} ({why.splitlines()[0]})")
    assert name == "pil" and "error" in why
    assert native.core() is None
    with pytest.raises(RuntimeError, match="did not build"):
        native.load_resize_pad(records[0]["file_name"], 96, 1000, 160, 160,
                               True, False)
    monkeypatch.setattr(jax_transforms, "_native", None)
    kw = dict(TRANSFORMS["train"], canvas=(160, 224), max_gt=4)
    for seed, rec in enumerate(records):
        assert_equal_records(
            port_transforms.transform_record(
                rec, np.random.default_rng(seed), **kw),
            jax_transforms.transform_record(
                rec, np.random.default_rng(seed), **kw), f"seed {seed}")
    assert not os.path.exists(tmp_path / "build") or not any(
        p.suffix == ".so" for p in (tmp_path / "build").iterdir())

