"""The port's PNG reader and writer (``wsunet_tpu_torch.io.png``) and its
readers (``io.imread``) against PIL and OpenCV, on the CPU.

- The reader equals PIL bit for bit on every PNG of ``data_ablation``,
  and on hypothesis images of each colour type (gray, RGB, palette, gray +
  alpha, RGBA) at odd widths and width 1, encoded with every filter type
  present; the C unfilter equals the plain one (``unfilter_plain``), and
  the readers equal the JAX package's (PIL, and cv2's [R, G, B, Y]).
- The writer, read back by PIL, equals its input, and its files are
  within 10% of PIL's size on the fixtures.
- A bad CRC, a truncated file or a bad filter byte raises ``PngError``;
  a 16-bit or an interlaced file raises ``UserError`` naming the file
  and its IHDR; in the pipeline the first give a failed image (a NaN
  row), the second raises.
- The unfilter is built by g++ under ``build/kernels``; a failed build
  raises with the compiler's first error line.
"""

import ctypes
import pathlib
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from torch_p128 import REPO
from wsunet_tpu.io import imread as jimread
from wsunet_tpu_torch.data import pipeline
from wsunet_tpu_torch.io import imread as timread
from wsunet_tpu_torch.io import png
from wsunet_tpu_torch.utils.errors import UserError

FIXTURES = sorted((REPO / "data_ablation").glob("*/images/*.png"))
# bytes a pixel of each colour type, and the PIL mode it reads as
BPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
MODE = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def test_there_are_80_fixture_pngs():
    assert len(FIXTURES) == 80


@pytest.mark.parametrize("path", FIXTURES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_reader_equals_pil_on_the_fixtures(path):
    got, want = png.read_png(path), np.array(Image.open(path))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _encode(pixels: np.ndarray, color_type: int, filters, palette=None):
    """PNG bytes of ``pixels`` with row y filtered by ``filters[y]``."""
    h, w = pixels.shape[:2]
    raw = np.ascontiguousarray(pixels).reshape(h, -1)
    cand = png.filter_rows(raw, BPP[color_type])
    rows = cand[np.asarray(filters), np.arange(h)]
    data = png.encode(rows, np.asarray(filters), h, w, color_type)
    if palette is not None:   # PLTE goes between IHDR and IDAT
        ihdr_end = 8 + 25
        data = (data[:ihdr_end] + png._chunk(b"PLTE", palette.tobytes()) +
                data[ihdr_end:])
    return data


@st.composite
def images(draw):
    color_type = draw(st.sampled_from(sorted(BPP)))
    h = draw(st.integers(5, 12))
    w = draw(st.sampled_from([1, 2, 3, 7, 9, 13, 17]))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    palette = None
    if color_type == 3:
        n = draw(st.integers(1, 256))
        palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        pixels = rng.integers(0, n, (h, w), dtype=np.uint8)
    else:
        shape = (h, w) if BPP[color_type] == 1 else (h, w, BPP[color_type])
        # smooth images and noise, so that the filters see both
        pixels = rng.integers(0, 256, shape, dtype=np.uint8)
        if draw(st.booleans()):
            pixels = np.cumsum(pixels // 16, axis=1).astype(np.uint8)
    # every filter type, in a drawn order, then drawn ones
    filters = list(rng.permutation(5)) + list(rng.integers(0, 5, h - 5))
    return color_type, pixels, filters, palette


@settings(max_examples=60, deadline=None)
@given(images())
def test_reader_equals_pil_and_the_plain_unfilter(tmp_path_factory, image):
    color_type, pixels, filters, palette = image
    path = tmp_path_factory.mktemp("png") / "x.png"
    path.write_bytes(_encode(pixels, color_type, filters, palette))
    with Image.open(path) as im:
        assert im.mode == MODE[color_type]
        want = np.array(im)
    got = png.read(path)
    assert got.color_type == color_type
    np.testing.assert_array_equal(got.pixels, want)
    np.testing.assert_array_equal(got.pixels, pixels)
    # the plain unfilter of the same stream
    idat = b"".join(body for kind, body in
                    png._chunks(path.read_bytes(), path) if kind == b"IDAT")
    h, w = pixels.shape[:2]
    plain = png.unfilter_plain(zlib.decompress(idat), h, w,
                               BPP[color_type])
    np.testing.assert_array_equal(plain.reshape(pixels.shape), pixels)
    # the readers against the JAX package's (PIL; cv2 for the colour
    # planes: the palette looked up, alpha dropped)
    for name in ("imread_u8", "imread4_u8"):
        g, w_ = getattr(timread, name)(path), getattr(jimread, name)(path)
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_, err_msg=name)
    np.testing.assert_array_equal(got.rgb(),
                                  cv2.imread(str(path))[..., ::-1])
    if color_type == 4:
        # [H, W, 2] has no third plane: both packages raise
        with pytest.raises(IndexError):
            jimread.imread_gray_u8(path)
        with pytest.raises(IndexError):
            timread.imread_gray_u8(path)
    else:
        np.testing.assert_array_equal(timread.imread_gray_u8(path),
                                      jimread.imread_gray_u8(path))


def test_the_wavefront_runs_equal_the_plain_unfilter():
    """Paeth runs longer than the wavefront's rows (8 at one byte a
    pixel, 4 above), with other filters between them, at widths above the
    wavefront's rows; the scans hold random bytes."""
    rng = np.random.default_rng(3)
    for bpp in (1, 2, 3, 4):
        for w in (9, 10, 33):
            h = 40
            scan = rng.integers(0, 256, (h, 1 + w * bpp), dtype=np.uint8)
            scan[:, 0] = 4
            scan[[0, 11, 12, 30], 0] = [1, 2, 3, 0]
            got = png.unfilter([bytearray(scan.tobytes())],
                               [(h, w, bpp)])[0]
            want = png.unfilter_plain(scan.tobytes(), h, w, bpp)
            np.testing.assert_array_equal(got, want, err_msg=f"{bpp} {w}")


@settings(max_examples=30, deadline=None)
@given(st.sampled_from([1, 2, 3, 4]), st.integers(1, 9), st.integers(1, 9),
       st.integers(0, 2**31 - 1))
def test_the_writer_round_trips_through_pil(tmp_path_factory, c, h, w,
                                            seed):
    x = np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                             dtype=np.uint8)
    path = tmp_path_factory.mktemp("w") / "x.png"
    png.write_png(path, x[..., 0] if c == 1 else x)
    with Image.open(path) as im:
        assert im.mode == {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[c]
        back = np.array(im)
    np.testing.assert_array_equal(back, x[..., 0] if c == 1 else x)
    np.testing.assert_array_equal(png.read_png(path), back)


def test_the_writer_is_within_10_percent_of_pil(tmp_path):
    ratios = []
    for i, path in enumerate(FIXTURES):
        x = png.read_png(path)
        ours, pils = tmp_path / f"o{i}.png", tmp_path / f"p{i}.png"
        png.write_png(ours, x)
        Image.fromarray(x).save(pils)
        np.testing.assert_array_equal(np.array(Image.open(ours)), x)
        ratios.append(ours.stat().st_size / pils.stat().st_size)
    assert 0.9 <= min(ratios) and max(ratios) <= 1.1, (min(ratios),
                                                       max(ratios))


def test_write_png_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(tmp_path / "a.png", np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="1-4"):
        png.write_png(tmp_path / "a.png", np.zeros((4, 4, 5), np.uint8))


def _fixture_bytes() -> bytes:
    return FIXTURES[0].read_bytes()


def test_a_bad_crc_raises(tmp_path):
    data = bytearray(_fixture_bytes())
    data[8 + 25 + 8 + 3] ^= 0x40   # a byte of the first chunk after IHDR
    bad = tmp_path / "crc.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(png.PngError, match="CRC"):
        png.read_png(bad)


@pytest.mark.parametrize("keep", [20, 40, 1000, -12, -1])
def test_a_truncated_file_raises(tmp_path, keep):
    bad = tmp_path / "cut.png"
    bad.write_bytes(_fixture_bytes()[:keep])
    with pytest.raises(png.PngError):
        png.read_png(bad)


def test_not_a_png_and_a_bad_filter_byte_raise(tmp_path):
    bad = tmp_path / "text.png"
    bad.write_bytes(b"not a png at all, longer than a signature")
    with pytest.raises(png.PngError, match="signature"):
        png.read_png(bad)
    x = np.arange(12, dtype=np.uint8).reshape(3, 4)
    data = png.encode(x, np.array([0, 5, 0]), 3, 4, 0)
    (tmp_path / "f.png").write_bytes(data)
    with pytest.raises(png.PngError, match="filter"):
        png.read_png(tmp_path / "f.png")


def test_16_bit_and_interlaced_files_raise_a_user_error(tmp_path):
    deep = tmp_path / "deep.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)\
        .save(deep)
    with pytest.raises(UserError, match=r"deep\.png.*8x8, bit depth 16"):
        png.read_png(deep)
    ihdr = struct.pack(">IIBBBBB", 8, 8, 8, 0, 0, 0, 1)
    adam7 = tmp_path / "adam7.png"
    adam7.write_bytes(png.SIGNATURE + png._chunk(b"IHDR", ihdr) +
                      png._chunk(b"IDAT", zlib.compress(b"\0" * 80)) +
                      png._chunk(b"IEND", b""))
    with pytest.raises(UserError, match=r"adam7\.png.*interlace 1"):
        png.read_png(adam7)


def test_the_pipeline_gives_failed_images_and_raises_user_errors(tmp_path):
    paths = [tmp_path / f"{i}.png" for i in range(3)]
    for p, src in zip(paths, FIXTURES):
        shutil.copyfile(src, p)
    data = bytearray(paths[1].read_bytes())
    data[-20] ^= 1
    paths[1].write_bytes(bytes(data))
    out = pipeline._decode_many(paths, timread.imread_gray_u8, threads=2)
    assert out[1] is None and out[0] is not None and out[2] is not None
    Image.fromarray(np.zeros((8, 8), np.uint16)).save(paths[2])
    with pytest.raises(UserError, match="bit depth 16"):
        pipeline._decode_many(paths, timread.imread_gray_u8, threads=2)


def test_the_unfilter_is_built_under_build_kernels_and_released_gil():
    so = png.library_path()
    assert so.parent == REPO / "build" / "kernels"
    assert so.name.startswith("libpng_unfilter_")
    lib = png._load()
    assert so.exists()
    # ctypes.CDLL (not PyDLL) releases the GIL for the call
    assert type(lib) is ctypes.CDLL


def test_a_failed_build_raises_with_the_first_error_line(tmp_path,
                                                         monkeypatch):
    broken = tmp_path / "png_unfilter.cpp"
    broken.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(png, "SOURCE", broken)
    monkeypatch.setattr(png, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(png, "_lib", None)
    with pytest.raises(RuntimeError,
                       match=r"g\+\+ failed to build png_unfilter\.cpp: "
                             r".*error"):
        png.read_png(FIXTURES[0])
    assert not list((tmp_path / "kernels").glob("*.so"))
