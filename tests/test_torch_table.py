"""The port's column table (``wsunet_tpu_torch.utils.table``) against
pandas, on the CPU.

- ``read_csv`` then ``to_csv`` writes, byte for byte, what
  ``pandas.read_csv`` then ``DataFrame.to_csv(index=False)`` writes, on
  every CSV under ``data_ablation/`` and ``splits/`` (the JAX CLI's
  outputs: ``tests/test_torch_runs.py``), and the table converts to the
  DataFrame pandas reads (the same dtypes).
- Floats are read as pandas' default parser reads them, on random
  strings of up to 30 digits (many are not the nearest double).
- ``shuffle`` is ``DataFrame.sample(frac=1.0, random_state=seed)``.
- ``concat``, ``sort``, ``groups``, ``drop_duplicates``, ``fillna``,
  ``from_rows`` and ``to_csv`` of float32, bool and text columns with
  NaN, against pandas on the same data.
- An empty header cell reads as ``Unnamed: <j>``, as pandas names it
  (``results/estimation/correlation.csv``, written with an unnamed
  index); ``medians`` is ``groupby(...).median()`` (NaN skipped) and
  ``insert`` is ``DataFrame.insert``.
"""

import io

import numpy as np
import pandas as pd
import pytest

from torch_p128 import REPO, frame
from wsunet_tpu_torch.utils import table
from wsunet_tpu_torch.utils.table import Table

CSVS = sorted(list((REPO / "data_ablation").rglob("*.csv")) +
              list((REPO / "splits").glob("*.csv")))


def round_trip_equals_pandas(path):
    """``read_csv`` -> ``to_csv`` against pandas' on ``path``; the table
    as a DataFrame against pandas' frame."""
    t = table.read_csv(path)
    df = pd.read_csv(path)
    assert t.to_csv() == df.to_csv(index=False)
    pd.testing.assert_frame_equal(frame(t), df)


def test_there_are_csvs_to_read():
    assert len(CSVS) >= 11


@pytest.mark.parametrize("path", CSVS, ids=lambda p: str(p.relative_to(REPO)))
def test_read_then_write_equals_pandas(path):
    round_trip_equals_pandas(path)


def test_device_column_stays_text(tmp_path):
    path = tmp_path / "split.csv"
    path.write_text("name,device,alpha\na.png,007,0.1\nb.png,,\n")
    t = table.read_csv(path, dtype={"device": str})
    df = pd.read_csv(path, dtype={"device": str})
    pd.testing.assert_frame_equal(frame(t), df)
    assert t.to_csv() == df.to_csv(index=False)


def test_inference_of_bool_int_float_text_and_na_strings(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("b,bn,i,f,s,e,na,q\n"
                    "True,False,3,1e-05,x,,NA,\"a,b\"\n"
                    "False,,-4,2,y,,None,\"say \"\"hi\"\"\"\n")
    round_trip_equals_pandas(path)


def test_floats_are_parsed_as_pandas_parses_them():
    rng = np.random.default_rng(0)
    vals = rng.random(3000) * 10.0 ** rng.integers(-30, 30, 3000)
    texts = [repr(float(v)) for v in vals]
    texts += ["0." + "".join(map(str, rng.integers(0, 10, k)))
              for k in rng.integers(1, 30, 2000)]
    texts += ["1e-320", "-2.5e-310", "123456789012345678901234.5", "-0.0",
              "+3.25e+2", "7E5", "inf", "-inf"]
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(texts) + "\n"))["x"]
    got = np.array([table._pandas_float(t) for t in texts])
    np.testing.assert_array_equal(got.view(np.int64),
                                  want.to_numpy().view(np.int64))
    # the case that made this necessary: pandas is not the nearest double
    assert table._pandas_float("0.16666666666666666") != 0.16666666666666666


@pytest.mark.parametrize("n", [0, 1, 2, 7, 64])
@pytest.mark.parametrize("seed", [0, 1, 3, 7, 12345])
def test_shuffle_equals_pandas_sample(n, seed):
    t = Table({"name": [f"{i:03d}" for i in range(n)], "v": np.arange(n)},
              n=n)
    df = pd.DataFrame({"name": [f"{i:03d}" for i in range(n)],
                       "v": np.arange(n)})
    want = df.sample(frac=1.0, random_state=seed)
    assert list(t.shuffle(seed)["v"]) == list(want["v"])
    assert list(want.index) == list(np.random.RandomState(seed)
                                    .permutation(n))


def _frames():
    a = Table({"name": ["b", "a", "c"], "i": [1, 2, 3],
               "f32": np.array([0.5, 1.25, np.nan], np.float32),
               "ok": [True, False, True]}, n=3)
    b = Table({"name": ["d", "e"], "s": ["x", "y"], "i": [4, 5]}, n=2)
    return a, b


def test_concat_equals_pandas():
    a, b = _frames()
    got = table.concat([a, b])
    want = pd.concat([frame(a), frame(b)]).reset_index(drop=True)
    pd.testing.assert_frame_equal(frame(got), want)
    assert got.to_csv() == want.to_csv(index=False)
    assert got.columns == ["name", "i", "f32", "ok", "s"]
    assert got["f32"].dtype == np.float32 and got["ok"].dtype == object


def test_sort_groups_duplicates_fillna_and_rows_equal_pandas():
    t = Table({"k": ["b", "a", "b", "a", np.nan],
               "m": ["y", "x", "x", "x", "z"], "v": [1, 2, 3, 2, 5]}, n=5)
    df = frame(t)
    s = t.sort(["k", "m"])
    want = df.sort_values(["k", "m"], kind="stable").reset_index(drop=True)
    pd.testing.assert_frame_equal(frame(s), want)
    keys = [k for k, _ in t.groups(["k", "m"])]
    assert keys == list(df.groupby(["k", "m"]).groups)
    for (k, m), g in t.groups(["k", "m"]):
        assert list(g["v"]) == list(df[(df.k == k) & (df.m == m)]["v"])
    pd.testing.assert_frame_equal(
        frame(t[["k", "v"]].drop_duplicates()),
        df[["k", "v"]].drop_duplicates().reset_index(drop=True))
    np.testing.assert_array_equal(table.fillna(t["k"], "Cover"),
                                  df["k"].fillna("Cover").to_numpy())
    f = np.array([np.nan, 1.0])
    np.testing.assert_array_equal(table.fillna(f, 0.0), [0.0, 1.0])
    np.testing.assert_array_equal(table.fillna(f, "Cover"),
                                  np.array(["Cover", 1.0], object))
    rows = [{"a": "x", "b": 1, "c": 0.5}, {"a": "y", "b": 2, "c": 0.25}]
    pd.testing.assert_frame_equal(frame(table.from_rows(rows)),
                                  pd.DataFrame(rows))


def test_row_selection_and_columns():
    a, _ = _frames()
    assert list(a[1:]["name"]) == ["a", "c"]
    assert list(a[a["i"] > 1]["name"]) == ["a", "c"]
    assert list(a[[2, 0]]["name"]) == ["c", "b"]
    assert len(a[[]]) == 0 and a[[]].columns == a.columns
    a["const"] = "x"
    a["flag"] = False
    a["n"] = 7
    assert a["const"].dtype == object and a["flag"].dtype == bool
    assert a["n"].dtype == np.int64 and list(a) == a.columns
    with pytest.raises(ValueError, match="rows"):
        a["bad"] = [1, 2]


def test_to_csv_of_float32_bool_and_text_with_nan_equals_pandas():
    t = Table({"f32": np.array([0.1, 1e-5, np.nan, 3.0], np.float32),
               "f64": [0.1, 1e-05, np.nan, 1e16],
               "b": [True, False, True, False],
               "s": np.array(["a", np.nan, "c,d", "e"], object),
               "o": np.array([True, np.nan, False, 0.5], object)}, n=4)
    assert t.to_csv() == frame(t).to_csv(index=False)


def test_an_empty_header_cell_is_named_as_pandas_names_it():
    path = REPO / "results" / "estimation" / "correlation.csv"
    t = table.read_csv(path)
    assert t.columns[0] == "Unnamed: 0"
    assert list(t["Unnamed: 0"]) == ["correlation", "p-value"]
    round_trip_equals_pandas(path)


def test_unnamed_header_cells_anywhere(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text(",a,,b\nx,1,2.5,\ny,3,,z\n")
    round_trip_equals_pandas(path)
    assert table.read_csv(path).columns == ["Unnamed: 0", "a", "Unnamed: 2",
                                            "b"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_medians_equal_pandas_groupby_median(seed):
    """Odd and even groups, NaN in some values and keys, an all-NaN
    group."""
    rng = np.random.default_rng(seed)
    n = 41
    key = rng.choice(["KB", "1", "AVG", "UNet_x"], n).astype(object)
    key[rng.random(n) < 0.1] = np.nan
    a, b = rng.normal(size=n), rng.exponential(size=n) * 1e-9
    a[rng.random(n) < 0.2] = np.nan
    b[key == "AVG"] = np.nan
    t = Table({"model_name": key, "correlation": a, "p-value": b})
    got = t.medians("model_name", ["correlation", "p-value"])
    want = frame(t).groupby("model_name")[
        ["correlation", "p-value"]].median().reset_index()
    pd.testing.assert_frame_equal(frame(got), want, check_exact=True)
    assert got.to_csv() == want.to_csv(index=False)


def test_insert_equals_pandas_insert():
    t = Table({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    df = frame(t)
    t.insert(0, "alpha", 0.01)
    df.insert(0, "alpha", 0.01)
    t.insert(2, "c", [True, False, True])
    df.insert(2, "c", [True, False, True])
    assert t.to_csv() == df.to_csv(index=False)
    pd.testing.assert_frame_equal(frame(t), df)
    with pytest.raises(ValueError, match="already exists"):
        t.insert(0, "a", 1)
