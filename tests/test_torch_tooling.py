"""The port's tooling against the JAX package's: TUM trajectory IO, the
dataset YAML, the image codec, image-folder datasets (ATAN included), the
synthetic dataset writer and the frame annotation."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import yaml
from PIL import Image

from plsvo_torch.camera import ATANCamera as TAtan
from plsvo_torch.camera import PinholeCamera as TPin
from plsvo_torch.utils import dataset as tds
from plsvo_torch.utils import imageio
from plsvo_torch.utils import trajectory as ttraj
from plsvo_torch.utils import viz as tviz
from plsvo_tpu import lie
from plsvo_tpu.utils import dataset as jds
from plsvo_tpu.utils import trajectory as jtraj
from plsvo_tpu.utils import viz as jviz


def _entries(rng, n=6):
    out = []
    for i in range(n):
        xi = rng.normal(0, 0.4, 6).astype(np.float32)
        R, t = lie.se3_exp(jnp.asarray(xi))
        out.append((i / 30.0, np.asarray(R), np.asarray(t)))
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tum_written_by_one_read_by_other(writer, tmp_path, rng):
    entries = _entries(rng)
    p = str(tmp_path / "traj.txt")
    (ttraj if writer == "port" else jtraj).write_tum(p, entries)
    other = str(tmp_path / "other.txt")
    (jtraj if writer == "port" else ttraj).write_tum(other, entries)
    assert open(p).read() == open(other).read()
    for reader in (ttraj, jtraj):
        back = reader.read_tum(p)
        assert len(back) == len(entries)
        for (ts, R, t), (ts2, pos, q) in zip(entries, back):
            assert abs(ts2 - ts) < 1e-6
            np.testing.assert_allclose(pos, -R.T @ t, atol=1e-6)
            np.testing.assert_allclose(ttraj.quaternion_to_rotation(q), R.T,
                                       atol=1e-5)
    for (a, b) in zip(ttraj.read_tum(p), jtraj.read_tum(p)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


@pytest.mark.parametrize("axis,angle", [
    ([0.3, -0.2, 0.9], 0.7),  # trace > 0
    ([1.0, 0.1, 0.05], np.pi - 1e-3),  # near 180 degrees: x dominates
    ([0.1, 1.0, -0.05], np.pi - 1e-4),  # y dominates
    ([0.05, -0.1, 1.0], np.pi),  # z dominates, exactly 180 degrees
    ([1.0, 1.0, 0.0], 2.5)])
def test_quaternion_round_trip_matches_jax(axis, angle):
    R = _rot(axis, angle)
    q = ttraj.rotation_to_quaternion(R)
    np.testing.assert_array_equal(q, jtraj.rotation_to_quaternion(R))
    np.testing.assert_allclose(np.linalg.norm(q), 1.0, atol=1e-12)
    np.testing.assert_allclose(ttraj.quaternion_to_rotation(q), R, atol=1e-9)
    np.testing.assert_array_equal(ttraj.quaternion_to_rotation(q),
                                  jtraj.quaternion_to_rotation(q))


ATAN_YAML = """# ATAN camera of the reference's dataset_params.yaml schema
cam0:
  cam_model: ATAN
  cam_width: 752
  cam_height: 480
  cam_fx: 0.611   # normalized
  cam_fy: 0.958
  cam_cx: 0.5
  cam_cy: 0.49
  cam_d0: 0.93
images_subfolder: "frames/"
"""


def test_yaml_parser_matches_safe_load(tmp_path):
    texts = [tds.dataset_yaml(320, 240, 460.0 * 320 / 752, 460.0 * 320 / 752,
                              160.0, 120.0), ATAN_YAML,
             ATAN_YAML.replace("0.93", "9.3e-1").replace("752", "1_024")
             + "extra: ~\nflag: yes\nname: 'a: b'\n"]
    for text in texts:
        assert tds.parse_yaml(text) == yaml.safe_load(text)
    p = tmp_path / "dataset_params.yaml"
    p.write_text(ATAN_YAML)
    cam, sub = tds.load_dataset_params(str(p))
    assert isinstance(cam, TAtan) and sub == "frames/"
    assert cam == TAtan.create(752, 480, 0.611, 0.958, 0.5, 0.49, w=0.93)
    with pytest.raises(ValueError):
        tds.parse_yaml("cam0:\n  - 1\n")


@pytest.mark.parametrize("shape", [(40, 56), (1, 7), (33, 1)])
def test_png_pgm_codec_against_pil(shape, tmp_path, rng):
    img = rng.integers(0, 256, shape).astype(np.uint8)
    # PIL writes adaptive filters (sub, up, average, paeth): decoded bit-exact
    p = str(tmp_path / "pil.png")
    Image.fromarray(img).save(p)
    np.testing.assert_array_equal(imageio.decode_png(open(p, "rb").read()), img)
    Image.fromarray(img).save(str(tmp_path / "pil.pgm"))
    np.testing.assert_array_equal(
        imageio.decode_pgm(open(tmp_path / "pil.pgm", "rb").read()), img)
    # the port's files, read by PIL
    q = str(tmp_path / "port.png")
    imageio.write_png(q, img)
    np.testing.assert_array_equal(np.asarray(Image.open(q)), img)
    open(tmp_path / "port.pgm", "wb").write(imageio.encode_pgm(img))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.pgm")),
                                  img)
    rgb = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    imageio.write_png(q, rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(q)), rgb)


def test_png_decoder_rejects_what_it_does_not_read(tmp_path, rng):
    rgb = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(str(tmp_path / "rgb.png"))
    with pytest.raises(ValueError, match="greyscale"):
        imageio.read_gray(str(tmp_path / "rgb.png"))
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError):
        imageio.read_gray(str(tmp_path / "x.jpg"))


def test_load_gray_falls_back_in_order(monkeypatch, tmp_path, rng):
    """native, then cv2, then PIL, then the numpy decoder; last_decoder
    names the one that served."""
    img = rng.integers(0, 256, (20, 30)).astype(np.uint8)
    p = str(tmp_path / "x.png")
    Image.fromarray(img).save(p)

    def missing(path):
        raise ImportError("not installed")

    seen = []
    for name in ("_native", "_cv2", "_pil"):
        out = tds.load_gray(p)
        np.testing.assert_array_equal(out, img.astype(np.float32))
        seen.append(tds.last_decoder)
        monkeypatch.setattr(tds, name, missing)
    out = tds.load_gray(p)
    np.testing.assert_array_equal(out, img.astype(np.float32))
    seen.append(tds.last_decoder)
    # the native loader may not build here: then cv2 serves first
    assert seen[1:] == ["cv2", "PIL", "numpy"], seen
    assert seen[0] in ("native", "cv2"), seen


def test_atan_dataset_ideal_camera(tmp_path, rng):
    """tests/test_pipeline.py::test_atan_dataset_ideal_camera on the port,
    the frame against the JAX dataset's."""
    from plsvo_tpu.camera import ATANCamera

    folder = tmp_path / "imgs"
    folder.mkdir()
    img = rng.uniform(0, 255, (48, 64)).astype(np.uint8)
    Image.fromarray(img).save(folder / "f0.png")
    cam = TAtan.create(64, 48, 0.8, 0.8, 0.5, 0.5, w=0.9)
    dset = tds.ImageFolderDataset(str(folder), cam)
    assert dset._maps is not None
    ideal = dset.ideal_camera()
    assert isinstance(ideal, TPin) and not ideal.has_distortion
    assert ideal.fx == cam.fx
    _, frame = next(iter(dset))
    assert frame.shape == (48, 64)
    jset = jds.ImageFolderDataset(str(folder), ATANCamera.create(
        64, 48, 0.8, 0.8, 0.5, 0.5, w=0.9))
    np.testing.assert_allclose(frame, next(iter(jset))[1], atol=2e-2)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    kw = dict(n_frames=4, width=320, height=240)
    port = tds.write_synthetic_dataset(str(root / "port"), device="cpu", **kw)
    jax_ = jds.write_synthetic_dataset(str(root / "jax"), **kw)
    return port, jax_


def test_synthetic_dataset_matches_jax(datasets):
    port, jax_ = datasets
    for name in ("groundtruth.txt", "dataset_params.yaml"):
        assert open(os.path.join(port, name)).read() == \
            open(os.path.join(jax_, name)).read(), name
    names = sorted(os.listdir(os.path.join(port, "images")))
    assert names == sorted(os.listdir(os.path.join(jax_, "images")))
    assert len(names) == 4
    for n in names:
        a = np.asarray(Image.open(os.path.join(port, "images", n)), np.int32)
        b = np.asarray(Image.open(os.path.join(jax_, "images", n)), np.int32)
        assert np.abs(a - b).max() <= 1, n
    cam, sub = tds.load_dataset_params(os.path.join(port, "dataset_params.yaml"))
    jcam, jsub = jds.load_dataset_params(os.path.join(jax_, "dataset_params.yaml"))
    assert sub == jsub and not cam.has_distortion
    assert (cam.fx, cam.cx, cam.width) == (float(jcam.fx), float(jcam.cx),
                                            jcam.width)


def test_draw_tracks_and_frame_png_match_jax(tmp_path, rng):
    img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    uv = rng.uniform(-5, 85, (12, 2)).astype(np.float32)
    ok = rng.random(12) > 0.3
    s, e = (rng.uniform(0, 80, (5, 2)).astype(np.float32) for _ in range(2))
    sv = rng.random(5) > 0.3
    got = tviz.draw_tracks(img, uv, ok, s, e, sv)
    np.testing.assert_array_equal(got, jviz.draw_tracks(img, uv, ok, s, e, sv))
    np.testing.assert_array_equal(tviz.draw_tracks(img, uv, ok),
                                  jviz.draw_tracks(img, uv, ok))
    p = str(tmp_path / "f.png")
    tviz.save_frame_png(p, got)
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")), got)
