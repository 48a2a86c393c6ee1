"""A small column table: an ordered dict of equal-length numpy columns.

The catalog, the sweeps' rows and the ROC tables are tables of this kind,
so that the detection path runs where pandas is not installed.  It has
only what that path uses, with pandas' semantics where the files or the
rows show them:

- ``read_csv`` (the standard library's ``csv``) infers each column as
  ``pandas.read_csv`` does on the repository's files: int64, float64
  (empty cells and pandas' NA strings are NaN), bool, or str (an object
  array, NaN where empty); ``dtype={"name": str}`` keeps a column as text.
  Floats are parsed as pandas' default parser parses them
  (``_pandas_float``: at most 17 significant digits, scaled by a power of
  ten), which is not always the nearest double to a long decimal, so
  both packages select the same rows from the same file;
- ``to_csv`` writes what ``DataFrame.to_csv(index=False)`` writes for the
  same columns, byte for byte (floats through numpy's ``astype(str)``,
  as pandas formats them);
- ``concat`` joins the columns in their order of first appearance and
  gives a column missing from some tables NaN there (int64 becomes
  float64, bool becomes object), as ``pandas.concat`` does;
- ``sort`` is stable (pandas' default sort is not, which only matters for
  ties); ``shuffle(seed)`` is ``DataFrame.sample(frac=1.0,
  random_state=seed)``, the permutation of ``np.random.RandomState(seed)``;
- ``groups`` iterates the sorted distinct keys of some columns, NaN keys
  left out, as ``groupby`` does, and ``medians`` takes each group's
  median skipping NaN (``groupby(...).median()``); ``drop_duplicates``
  keeps first rows; ``insert`` puts a column at a position
  (``DataFrame.insert``);
- ``read_csv`` names an empty header cell ``Unnamed: <j>`` (``j`` its
  position), as pandas does, so a file written with an unnamed index
  column reads and writes back the same bytes.

A table has no index: rows are positions.  ``table[name]`` is a column,
``table[rows]`` (a slice, a bool mask or positions) a table of those
rows.  The package imports no pandas; the tests convert a table to a
DataFrame themselves (``tests/torch_p128.frame``).
"""

import csv
import io
import math
import re
import typing

import numpy as np

# pandas.read_csv's default NA strings
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(
    r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|Inf|INF"
    r"|infinity|Infinity)\Z")
_DIGITS = "0123456789"
# powers of ten as pandas' parser holds them (e[i] = 1e<i>, each the
# nearest double)
_POW10 = [float(f"1e{i}") for i in range(309)]
_TRUE = frozenset(["True", "TRUE", "true"])
_FALSE = frozenset(["False", "FALSE", "false"])


def isna(values) -> np.ndarray:
    """bool [n]: where ``values`` (a column) is NaN or None."""
    v = np.asarray(values)
    if v.dtype.kind == "f":
        return np.isnan(v)
    if v.dtype.kind == "O":
        return np.fromiter((x is None or (isinstance(x, float) and
                                          math.isnan(x)) for x in v),
                           bool, len(v))
    return np.zeros(len(v), bool)


def _column(values, n: int = None) -> np.ndarray:
    """A column from a scalar (broadcast to ``n`` rows) or a sequence:
    text becomes an object array, never a numpy string array."""
    if isinstance(values, np.ndarray) and values.ndim == 1:
        if values.dtype.kind in "US":
            return values.astype(object)
        return values
    if isinstance(values, (str, bytes)) or values is None or \
            np.ndim(values) == 0:
        if n is None:
            raise ValueError("a scalar column needs a row count")
        if isinstance(values, (bool, np.bool_)):
            return np.full(n, bool(values))
        if isinstance(values, (int, np.integer)):
            return np.full(n, values, np.int64)
        if isinstance(values, (float, np.floating)):
            return np.full(n, values, np.asarray(values).dtype)
        out = np.empty(n, object)
        out[:] = [values] * n
        return out
    values = list(values)
    if values and all(isinstance(v, str) for v in values):
        out = np.empty(len(values), object)
        out[:] = values
        return out
    arr = np.asarray(values)
    if arr.dtype.kind in "US" or arr.ndim != 1:
        out = np.empty(len(values), object)
        out[:] = values
        return out
    return arr


class Table:
    """Ordered named columns of one length (see the module docstring)."""

    def __init__(self, columns: typing.Mapping = None, n: int = None):
        self._cols = {}
        self._n = n
        for name, values in (columns or {}).items():
            self[name] = values
        if self._n is None:
            self._n = 0

    @property
    def columns(self) -> typing.List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __iter__(self):
        """The column names, as a DataFrame iterates."""
        return iter(self._cols)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, list) and key and all(isinstance(k, str)
                                                 for k in key):
            return Table({k: self._cols[k] for k in key}, n=self._n)
        if isinstance(key, slice):
            idx = np.arange(self._n)[key]
        else:
            idx = np.asarray(key)
            if idx.dtype == bool:
                if len(idx) != self._n:
                    raise IndexError(f"mask of {len(idx)} for {self._n} rows")
                idx = np.flatnonzero(idx)
            else:
                idx = idx.astype(np.int64).reshape(-1)
        return Table({k: v[idx] for k, v in self._cols.items()},
                     n=len(idx))

    def __setitem__(self, name: str, values):
        col = _column(values, self._n)
        if self._n is None:
            self._n = len(col)
        if len(col) != self._n:
            raise ValueError(f"column {name!r} has {len(col)} rows, the "
                             f"table {self._n}")
        self._cols[name] = col

    def __repr__(self) -> str:
        return f"Table({self._n} rows: {', '.join(self._cols)})"

    def copy(self) -> "Table":
        return Table({k: v.copy() for k, v in self._cols.items()}, n=self._n)

    def drop(self, *names) -> "Table":
        return Table({k: v for k, v in self._cols.items()
                      if k not in names}, n=self._n)

    def sort(self, by) -> "Table":
        """Rows sorted by the column(s) ``by``, stably, NaN last."""
        keys = [by] if isinstance(by, str) else list(by)
        codes = [_sort_codes(self._cols[k]) for k in keys]
        return self[np.lexsort(codes[::-1]) if codes else
                    np.arange(self._n)]

    def shuffle(self, seed: int) -> "Table":
        """The rows in ``DataFrame.sample(frac=1.0, random_state=seed)``'s
        order."""
        return self[np.random.RandomState(seed).permutation(self._n)]

    def groups(self, by) -> typing.Iterator[typing.Tuple[tuple, "Table"]]:
        """(key tuple, rows) for each distinct key of the column(s)
        ``by``, keys sorted; rows with a NaN key are left out."""
        keys = [by] if isinstance(by, str) else list(by)
        cols = [self._cols[k] for k in keys]
        keep = ~np.any([isna(c) for c in cols], axis=0) if cols else \
            np.ones(self._n, bool)
        found = {}
        for i in np.flatnonzero(keep):
            found.setdefault(tuple(c[i] for c in cols), []).append(i)
        for key in sorted(found):
            yield key, self[np.asarray(found[key], dtype=np.int64)]

    def medians(self, by: str, columns) -> "Table":
        """One row a distinct key of ``by`` (sorted, NaN keys left out):
        the key and the median of each of ``columns`` over the group,
        NaN skipped (``groupby(by)[columns].median()`` with its index as
        a column)."""
        keys, meds = [], {c: [] for c in columns}
        for (key,), rows in self.groups(by):
            keys.append(key)
            for c in columns:
                v = np.asarray(rows[c], np.float64)
                v = v[~np.isnan(v)]
                meds[c].append(np.median(v) if len(v) else np.nan)
        out = Table({by: _column(keys)}, n=len(keys))
        for c in columns:
            out[c] = np.asarray(meds[c], np.float64)
        return out

    def insert(self, pos: int, name: str, values) -> None:
        """Put the column ``name`` at position ``pos`` (a scalar is
        broadcast), as ``DataFrame.insert`` does."""
        if name in self._cols:
            raise ValueError(f"column {name!r} already exists")
        col = _column(values, self._n)
        if len(col) != self._n:
            raise ValueError(f"column {name!r} has {len(col)} rows, the "
                             f"table {self._n}")
        items = list(self._cols.items())
        items.insert(pos, (name, col))
        self._cols = dict(items)

    def drop_duplicates(self) -> "Table":
        """The first row of each distinct row (NaN equal to NaN)."""
        seen, keep = set(), []
        for i, row in enumerate(zip(*self._cols.values())):
            key = tuple("\0nan" if _is_nan(x) else x for x in row)
            if key not in seen:
                seen.add(key)
                keep.append(i)
        return self[np.asarray(keep, dtype=np.int64)]

    # ------------------------------------------------------------- files

    def to_csv(self, path=None) -> typing.Optional[str]:
        """Write ``DataFrame.to_csv(path, index=False)``'s bytes for these
        columns to ``path``; without a path, return them as text."""
        cols = [_csv_cells(v) for v in self._cols.values()]
        buf = io.StringIO()
        writer = csv.writer(buf, lineterminator="\n")
        writer.writerow(self.columns)
        writer.writerows(zip(*cols))
        text = buf.getvalue()
        if path is None:
            return text
        with open(path, "w", newline="") as f:
            f.write(text)
        return None

    def to_string(self) -> str:
        """The rows as aligned text, a header line first (for printing)."""
        cells = [[name] + _csv_cells(col)
                 for name, col in self._cols.items()]
        widths = [max(map(len, c)) for c in cells]
        return "\n".join("  ".join(c[i].rjust(w)
                                   for c, w in zip(cells, widths))
                         for i in range(self._n + 1))


def from_rows(rows: typing.Sequence[dict]) -> Table:
    """A table of dict rows (``pandas.DataFrame(rows)``): columns in their
    order of first appearance, NaN where a row lacks one."""
    names = list(dict.fromkeys(k for r in rows for k in r))
    return Table({k: [r.get(k, np.nan) for r in rows] for k in names},
                 n=len(rows))


def as_table(frame) -> Table:
    """A ``Table`` itself, or the columns of anything with ``columns``
    and ``frame[name]`` (a pandas DataFrame) as a table."""
    if isinstance(frame, Table):
        return frame
    return Table({str(k): np.asarray(frame[k]) for k in frame.columns},
                 n=len(frame))


def concat(tables: typing.Sequence[Table]) -> Table:
    """The rows of ``tables`` in order (``pandas.concat``)."""
    tables = list(tables)
    if not tables:
        raise ValueError("no tables to concatenate")
    names = list(dict.fromkeys(k for t in tables for k in t.columns))
    n = sum(len(t) for t in tables)
    out = Table(n=n)
    for name in names:
        parts = [t[name] if name in t else None for t in tables]
        present = [p for p in parts if p is not None]
        dtype = _common_dtype([p.dtype for p in present],
                              missing=len(present) < len(parts))
        col = np.empty(n, dtype)
        at = 0
        for t, p in zip(tables, parts):
            col[at:at + len(t)] = np.nan if p is None else p
            at += len(t)
        out[name] = col
    return out


def fillna(col: np.ndarray, value) -> np.ndarray:
    """``col`` with ``value`` where it is NaN (a text value makes the
    column text, as ``Series.fillna`` does)."""
    out = col.astype(object) if isinstance(value, str) and \
        col.dtype != object else col.copy()
    out[isna(col)] = value
    return out


def take(col: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``col[idx]`` with NaN where ``idx`` is -1 (int64 becomes float64,
    bool object, as pandas fills a missing row)."""
    idx = np.asarray(idx, np.int64)
    miss = idx < 0
    if not miss.any():
        return col[idx]
    out = np.empty(len(idx), _common_dtype([col.dtype], missing=True))
    out[~miss] = col[idx[~miss]]
    out[miss] = np.nan
    return out


def _common_dtype(dtypes, missing: bool) -> np.dtype:
    kinds = {d.kind for d in dtypes}
    if "O" in kinds or ("b" in kinds and len(kinds) > 1) or \
            (kinds == {"b"} and missing):
        return np.dtype(object)
    dtype = np.result_type(*dtypes)
    if missing and dtype.kind in "iu":
        return np.dtype(np.float64)
    return dtype


def _is_nan(x) -> bool:
    return x is None or (isinstance(x, (float, np.floating)) and
                         math.isnan(x))


def _sort_codes(col: np.ndarray) -> np.ndarray:
    """Integer codes that order ``col`` as its values do, NaN last."""
    na = isna(col)
    if col.dtype.kind == "O":
        vals = [x for x, m in zip(col, na) if not m]
        order = {v: i for i, v in enumerate(sorted(set(vals)))}
        codes = np.full(len(col), len(order), np.int64)
        codes[~na] = [order[v] for v in vals]
        return codes
    codes = np.unique(col[~na], return_inverse=True)[1] if (~na).any() \
        else np.zeros(0, np.int64)
    out = np.full(len(col), int(codes.max()) + 1 if len(codes) else 0,
                  np.int64)
    out[~na] = codes.reshape(-1)
    return out


def _infer(cells: typing.List[str], as_text: bool) -> np.ndarray:
    na = [c in NA_STRINGS for c in cells]
    vals = [c for c, m in zip(cells, na) if not m]
    if as_text or (vals and not all(_FLOAT.match(v) or _INT.match(v)
                                    for v in vals)):
        if not as_text and vals and all(v in _TRUE or v in _FALSE
                                        for v in vals):
            col = [np.nan if m else (c in _TRUE) for c, m in zip(cells, na)]
            return np.array(col, bool if not any(na) else object)
        out = np.empty(len(cells), object)
        out[:] = [np.nan if m else c for c, m in zip(cells, na)]
        return out
    if vals and not any(na) and all(_INT.match(v) for v in vals):
        return np.array([int(v) for v in vals], np.int64)
    return np.array([np.nan if m else _pandas_float(c)
                     for c, m in zip(cells, na)], np.float64)


def _pandas_float(text: str) -> float:
    """``text`` as pandas' default float parser reads it (its C
    tokenizer's ``precise_xstrtod``): the first 17 significant digits,
    leading zeros included, accumulated in a double, then multiplied or
    divided by a power of ten.  Where the digits fit 15 and the exponent
    22, each step is exact but the last, and the result is the nearest
    double, as ``float`` gives."""
    s = text.strip()
    mantissa, _, exp = s.lower().partition("e")
    if "inf" in mantissa:
        return float(s)
    digits = len(mantissa.lstrip("+-").replace(".", ""))
    if digits <= 15 and abs(int(exp or 0)) + digits <= 22:
        return float(s)
    i, n = 0, len(s)
    neg = i < n and s[i] == "-"
    i += i < n and s[i] in "+-"
    number, exponent, digits = 0.0, 0, 0
    while i < n and s[i] in _DIGITS:
        if digits < 17:
            number = number * 10.0 + _DIGITS.index(s[i])
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and s[i] == ".":
        i += 1
        decimals = 0
        while digits < 17 and i < n and s[i] in _DIGITS:
            number = number * 10.0 + _DIGITS.index(s[i])
            digits += 1
            decimals += 1
            i += 1
        while i < n and s[i] in _DIGITS:
            i += 1
        exponent -= decimals
    if neg:
        number = -number
    if i < n and s[i] in "eE":
        i += 1
        eneg = i < n and s[i] == "-"
        i += i < n and s[i] in "+-"
        e, edigits = 0, 0
        while edigits < 17 and i < n and s[i] in _DIGITS:
            e = e * 10 + _DIGITS.index(s[i])
            edigits += 1
            i += 1
        exponent += -e if eneg else e
    if exponent > 308:
        return -math.inf if neg else math.inf
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _csv_cells(col: np.ndarray) -> list:
    """The text of each cell as ``DataFrame.to_csv`` writes it."""
    if col.dtype.kind == "f":
        text = col.astype(str).astype(object)
        text[np.isnan(col)] = ""
        return list(text)
    if col.dtype.kind in "iub":
        return list(col.astype(str))
    return ["" if _is_nan(x) else x if isinstance(x, str) else str(x)
            for x in col]


def read_csv(path, dtype: typing.Mapping = None) -> Table:
    """A CSV file with a header line, each column inferred as
    ``pandas.read_csv`` infers it; ``dtype={"col": str}`` keeps a column
    as text."""
    with open(path, newline="") as f:
        lines = list(csv.reader(f))
    if not lines:
        raise ValueError(f"{path}: no header line")
    header, body = lines[0], [r for r in lines[1:] if r]
    table = Table(n=len(body))
    for j, name in enumerate(header):
        name = name or f"Unnamed: {j}"
        cells = [r[j] if j < len(r) else "" for r in body]
        table[name] = _infer(cells, (dtype or {}).get(name) is str)
    return table
