"""The port's copy of the native loader, as tests/test_native_loader.py
holds the JAX package's: PGM, PNG (grey and RGB) and BMP decoding, the
prefetcher, and utils.dataset.load_gray reading through it. The library
builds into build/plsvo_torch_native/, never next to its source."""
import numpy as np
import pytest
from PIL import Image

from plsvo_torch.native import loader


@pytest.fixture(scope="module")
def lib():
    lib = loader.get_lib()
    if lib is None:
        pytest.skip("native loader failed to build")
    return lib


def test_library_is_built_outside_the_sources(lib):
    from pathlib import Path

    path = Path(lib._name).resolve()
    assert loader.BUILD_ROOT.resolve() in path.parents, path
    assert not any(p.suffix == ".so" for p in Path(loader.__file__).parent.iterdir())


def test_pgm_roundtrip(tmp_path, lib, rng):
    img = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    p = str(tmp_path / "t.pgm")
    with open(p, "wb") as fh:
        fh.write(b"P5\n64 48\n255\n")
        fh.write(img.tobytes())
    np.testing.assert_allclose(loader.load_gray(p), img.astype(np.float32))


def test_png_roundtrip_vs_pil(tmp_path, lib, rng):
    img = rng.integers(0, 256, (40, 56)).astype(np.uint8)
    p = str(tmp_path / "t.png")
    Image.fromarray(img).save(p)
    np.testing.assert_allclose(loader.load_gray(p), img.astype(np.float32))
    # RGB png -> luma
    rgb = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    p2 = str(tmp_path / "rgb.png")
    Image.fromarray(rgb).save(p2)
    luma = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])
    np.testing.assert_allclose(loader.load_gray(p2), luma, atol=1.0)


def test_bmp(tmp_path, lib, rng):
    import cv2

    img = rng.integers(0, 256, (24, 36)).astype(np.uint8)
    p = str(tmp_path / "t.bmp")
    cv2.imwrite(p, img)
    out = loader.load_gray(p)
    assert out is not None and out.shape == (24, 36)
    np.testing.assert_allclose(out, img.astype(np.float32), atol=1.0)


def test_prefetcher_streams_in_order(tmp_path, lib):
    paths = []
    for i in range(6):
        p = str(tmp_path / f"f{i}.png")
        Image.fromarray(np.full((16, 16), i * 10, np.uint8)).save(p)
        paths.append(p)
    pf = loader.Prefetcher(paths, 16, 16, depth=2)
    vals = [float(img[0, 0]) for img in pf]
    pf.close()
    assert vals == [0.0, 10.0, 20.0, 30.0, 40.0, 50.0]


def test_dataset_uses_native(tmp_path, lib, rng):
    """utils.dataset.load_gray reads through the native decoder."""
    from plsvo_torch.utils import dataset as ds

    img = rng.integers(0, 256, (20, 20)).astype(np.uint8)
    p = str(tmp_path / "x.png")
    Image.fromarray(img).save(p)
    np.testing.assert_allclose(ds.load_gray(p), img.astype(np.float32))
    assert ds.last_decoder == "native"
