"""Port parity: the catalog, the batched pipeline and the image readers
(wsunet_tpu_torch.data, wsunet_tpu_torch.io) against the JAX package's
(wsunet_tpu.data, wsunet_tpu.io), on a catalog of p128 covers with LSBr
stego made by the JAX package's ``simulate``.  Catalog frames must be
equal (rows, columns, order, dtypes); decoded pixels bitwise equal."""

import concurrent.futures
import shutil
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from torch_p128 import P128, make_catalog
from wsunet_tpu import data as jdata
from wsunet_tpu.io import imread as jimread
from wsunet_tpu.ops import NAMED_FILTERS_2D
from wsunet_tpu.ws.estimate import attack_sweep as jax_attack_sweep
from wsunet_tpu_torch import data as tdata
from wsunet_tpu_torch.data import pipeline
from wsunet_tpu_torch.io import imread as timread
from wsunet_tpu_torch.io import native
from wsunet_tpu_torch.ws import attack_sweep


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_catalog(tmp_path_factory.mktemp("p128"), n=12)


def test_resolve_path_matches_lsbr_case(root):
    name = "stego_LSBR_alpha_0.1_independent_images/6_00.png"
    assert not (root / name).exists()
    got = tdata.resolve_path(root, name)
    assert got.exists() and got.parent.name.startswith("stego_LSBr_")
    assert got == jdata.resolve_path(root, name)
    missing = "stego_LSBR_alpha_0.1_independent_images/nope.png"
    assert tdata.resolve_path(root, missing) == \
        jdata.resolve_path(root, missing)
    assert not tdata.resolve_path(root, missing).exists()


@pytest.mark.parametrize("select", [
    {}, {"take_num_images": 5}, {"shuffle_seed": 0},
    {"shuffle_seed": 3, "skip_num_images": 2, "take_num_images": 4}])
def test_precovers_matches_jax(root, select):
    pd.testing.assert_frame_equal(tdata.precovers(root, **select),
                                  jdata.precovers(root, **select))


@pytest.mark.parametrize("method, alpha", [
    ("LSBR", 0.1), ("LSBR", 0.01), ("LSBR", None), (None, None),
    ("LSBR", 0.4), ("HILLR", 0.1)])
def test_stego_spatial_matches_jax(root, method, alpha):
    got = tdata.stego_spatial(root, stego_method=method, alpha=alpha)
    want = jdata.stego_spatial(root, stego_method=method, alpha=alpha)
    pd.testing.assert_frame_equal(got, want)
    if method == "LSBR" and alpha == 0.1:
        assert len(got) == 12 and (got["alpha"] == 0.1).all()
    if alpha == 0.4 or method == "HILLR":
        assert len(got) == 0


def test_order_rows_and_pairs_match_jax(root):
    df = jdata.collect_files(root, ["images*", "stego*"])
    pd.testing.assert_frame_equal(
        tdata.collect_files(root, ["images*", "stego*"]), df)
    for kw in ({}, {"shuffle_seed": 7}, {"shuffle_seed": 0,
                                          "take_num_images": 9}):
        pd.testing.assert_frame_equal(tdata.order_rows(df, **kw),
                                      jdata.order_rows(df, **kw))
    pd.testing.assert_frame_equal(
        tdata.cover_stego_pairs(root, stego_method="LSBR", alpha=0.01),
        jdata.cover_stego_pairs(root, stego_method="LSBR", alpha=0.01))
    split = tdata.precovers(P128, split="split_tr.csv")
    pd.testing.assert_frame_equal(split,
                                  jdata.precovers(P128, split="split_tr.csv"))
    with pytest.raises(FileNotFoundError):
        tdata.collect_files(root, ["jpegs*"])


def test_readers_match_jax(root):
    path = root / "images" / "6_00.png"
    for name in ("imread_u8", "imread_f32", "imread4_u8", "imread4_f32",
                 "imread_gray_u8"):
        got, want = getattr(timread, name)(path), getattr(jimread, name)(path)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_native_decoder_matches_pil(root):
    assert native.available(), native.build_error()
    paths = sorted(str(p) for p in (root / "images").glob("*.png"))
    got = native.decode_gray_batch(paths, threads=2)
    for p, g in zip(paths, got):
        np.testing.assert_array_equal(g, timread.imread_gray_u8(p))
    assert native.library_path().parent.name == "native"
    assert native.library_path().parent.parent.name == "build"
    assert native.decode_gray_batch([str(root / "nope.png")]) is None


def test_native_colour_decoder_matches_imread4(tmp_path, monkeypatch):
    """``decode_rgby_batch`` and the pipeline's native ``imread4_u8``
    route, bitwise against ``io.imread4_u8`` (OpenCV's planes and
    luminance) on RGB PNGs made of three p128 covers each; a missing file
    gives None."""
    from PIL import Image

    assert native.available(), native.build_error()
    covers = sorted((P128 / "images").glob("*.png"))[:9]
    gray = [np.array(Image.open(p)) for p in covers]
    paths = []
    for i in range(3):
        rgb = np.stack(gray[3 * i:3 * i + 3], axis=-1)
        paths.append(str(tmp_path / f"rgb{i}.png"))
        Image.fromarray(rgb).save(paths[-1])
    want = [timread.imread4_u8(p) for p in paths]
    got = native.decode_rgby_batch(paths, threads=2)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (128, 128, 4) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    assert native.decode_rgby_batch(paths + [str(tmp_path / "no.png")]) \
        is None
    calls = []
    batch_call = native.decode_rgby_batch
    monkeypatch.setattr(native, "decode_rgby_batch",
                        lambda *a: calls.append(a) or batch_call(*a))
    pipeline.force_native(True)
    try:
        via = pipeline._decode_many(paths, timread.imread4_u8, threads=2)
    finally:
        pipeline.force_native(None)
    assert len(calls) == 1
    for g, w in zip(via, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("backend", [False, True])
def test_iterate_batches_tail_and_mask(root, backend):
    pipeline.force_native(backend)
    try:
        df = tdata.stego_spatial(root, stego_method="LSBR", alpha=0.1)
        got = list(tdata.iterate_batches(root, list(df["name"]),
                                         batch_size=5))
        want = list(jdata.iterate_batches(root, df, batch_size=5))
    finally:
        pipeline.force_native(None)
    assert [len(b.names) for b in got] == [5, 5, 2]
    for g, w in zip(got, want):
        assert g.pixels.shape == (5, 128, 128) and g.pixels.dtype == np.uint8
        np.testing.assert_array_equal(g.pixels, w.pixels)
        np.testing.assert_array_equal(g.mask, w.mask)
        assert g.names == list(w.rows["name"])
    # the tail repeats its first image, masked out
    np.testing.assert_array_equal(got[-1].mask, [1, 1, 0, 0, 0])
    np.testing.assert_array_equal(got[-1].pixels[2], got[-1].pixels[0])


def test_iterate_batches_empty_selection_and_load_images(root):
    df = tdata.stego_spatial(root, stego_method="LSBR", alpha=0.4)
    assert list(tdata.iterate_batches(root, list(df["name"]),
                                      batch_size=4)) == []
    assert attack_sweep(root, df, kernel_name="KB", device="cpu").shape == \
        (0,)
    names = list(tdata.precovers(root)["name"])
    np.testing.assert_array_equal(tdata.load_images(root, names),
                                  jdata.load_images(root, names))


@pytest.mark.parametrize("cache", [False, True])
def test_corrupt_png_gives_a_nan_row(tmp_path, root, cache):
    """A file that fails to decode is a masked row, and the attack sweep
    gives NaN there, as the JAX sweep does."""
    bad = tmp_path / "cat"
    shutil.copytree(root / "images", bad / "images")
    (bad / "images" / "6_02.png").write_bytes(b"not a png")
    df = tdata.precovers(bad)
    batches = list(tdata.iterate_batches(bad, list(df["name"]), batch_size=8,
                                         cache=cache))
    assert batches[0].mask.tolist() == [1, 1, 0, 1, 1, 1, 1, 1]
    assert not batches[0].pixels[2].any()
    got = attack_sweep(bad, df, kernel_name="KB", device="cpu")
    want = jax_attack_sweep(bad, df, kernel_name="KB",
                            pixel_kernel=NAMED_FILTERS_2D["KB"])
    assert np.isnan(got[2]) and np.isnan(want[2])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    pipeline.clear_decode_cache()


def test_caches_reuse_decodes_and_device_batches(root):
    pipeline.clear_decode_cache()
    names = list(tdata.precovers(root)["name"])
    first = list(tdata.iterate_batches(root, names, 8, cache=True,
                                       device_cache=True, device="cpu"))
    assert pipeline._DECODE_CACHE_BYTES == 12 * 128 * 128
    assert len(pipeline._DEVICE_CACHE) == 2
    second = list(tdata.iterate_batches(root, names, 8, cache=True,
                                        device_cache=True, device="cpu"))
    for a, b in zip(first, second):
        assert isinstance(b.pixels, torch.Tensor)
        assert b.pixels is a.pixels   # the cached tensor, no re-upload
        np.testing.assert_array_equal(a.mask, b.mask)
    # host batches are fresh arrays: writing one leaves the cache intact
    host = list(tdata.iterate_batches(root, names, 8, cache=True))
    host[0].pixels[:] = 0
    again = list(tdata.iterate_batches(root, names, 8, cache=True))
    assert again[0].pixels.any()
    pipeline.clear_device_cache()
    assert not pipeline._DEVICE_CACHE and pipeline._DECODE_CACHE
    pipeline.clear_decode_cache()
    assert not pipeline._DECODE_CACHE


def test_decode_cache_counts_bytes_under_concurrent_inserts(root):
    """Many threads insert overlapping images into the shared decode cache
    (as two prefetch workers do): the byte counter matches what the cache
    holds, with no image counted twice."""
    pipeline.clear_decode_cache()
    paths = sorted((root / "images").glob("*.png"))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=16) as pool:
            futs = [pool.submit(pipeline._decode_many,
                                paths[i % 5:i % 5 + 7], timread.imread_gray_u8,
                                1, True) for i in range(64)]
            for f in futs:
                assert len(f.result(timeout=60)) == 7
    finally:
        sys.setswitchinterval(old)
    with pipeline._DECODE_CACHE_LOCK:
        held = sum(d.nbytes for d in pipeline._DECODE_CACHE.values())
        assert pipeline._DECODE_CACHE_BYTES == held == 11 * 128 * 128
    pipeline.clear_decode_cache()
