"""Columnar vectors: the TPU analogue of Trino's Block hierarchy.

Reference: ``core/trino-spi/src/main/java/io/trino/spi/block/Block.java:25``
and its implementations (``LongArrayBlock``, ``VariableWidthBlock``,
``DictionaryBlock``, ``RunLengthEncodedBlock``).  The TPU design replaces the
object hierarchy with one struct-of-arrays record and three physical layouts:

- ``PLAIN``:  fixed-width values array ``[N]`` (covers Long/Int/Short/Byte
  ArrayBlock and decimal-as-int64).
- ``DICT``:   ``int32`` codes ``[N]`` + host-side string dictionary (covers
  DictionaryBlock; low-cardinality strings).
- ``BYTES``:  fixed-width ``uint8`` matrix ``[N, W]`` + lengths ``[N]``
  (covers VariableWidthBlock for strings that must be matched/compared on
  device, e.g. LIKE over comments).

Null handling follows the reference's per-position null mask
(``Block.java:289 isNull``): ``validity`` is a bool array, ``None`` meaning
all-valid (the common TPC-H case, where only outer joins introduce nulls).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Union

import numpy as np

from .types import (
    DataType,
    VarcharType,
    CharType,
    is_string,
)

PLAIN = "plain"
DICT = "dict"
BYTES = "bytes"
ARRAY = "array"   # values [N, W] of element dtype + lengths [N]
MAP = "map"       # values [N, W] keys + values2 [N, W] map-values + lengths
ROW = "row"       # host-edge only: named child Columns (device side is
                  # always SHREDDED into per-field columns)
RLE = "rle"       # run-length storage: values [R] run values + lengths [R]
                  # run lengths (the ``RunLengthEncodedBlock`` analogue;
                  # expands to dense on first device touch — one
                  # searchsorted gather — since every traced kernel wants
                  # dense vectors; constants stay trace-time scalars)

ArrayLike = Union[np.ndarray, "jax.Array"]  # noqa: F821 - device arrays allowed


@dataclass
class Column:
    dtype: DataType
    values: ArrayLike                       # PLAIN:[N] | DICT:[N] codes | BYTES:[N,W]
    validity: Optional[ArrayLike] = None    # bool [N]; None == all valid
    kind: str = PLAIN
    dictionary: Optional[np.ndarray] = None  # kind==DICT: np.ndarray of str objects
    lengths: Optional[ArrayLike] = None      # kind==BYTES/ARRAY/MAP: int32 [N]
    values2: Optional[ArrayLike] = None      # kind==MAP: map values [N, W]
    dictionary2: Optional[np.ndarray] = None  # kind==MAP: map-VALUE dict
    children: Optional[list] = None          # kind==ROW: [(field, Column)]

    def __post_init__(self):
        if self.kind == DICT and self.dictionary is None:
            raise ValueError("DICT column requires a dictionary")
        if self.kind == BYTES and self.lengths is None:
            self.lengths = np.full(
                self.values.shape[0],
                self.values.shape[1] if self.values.ndim > 1 else 0,
                dtype=np.int32,
            )

    @property
    def row_count(self) -> int:
        if self.kind == RLE:
            return int(np.asarray(self.lengths).sum())
        return int(self.values.shape[0])

    def decode_runs(self) -> "Column":
        """RLE → dense (host side): expand runs by repeat.  Device-side
        expansion lives in ``exec/columns.from_host`` (searchsorted
        gather) so HBM uploads move R runs, not N rows."""
        assert self.kind == RLE
        idx = np.repeat(np.arange(len(np.asarray(self.values))),
                        np.asarray(self.lengths))
        vals = np.asarray(self.values)[idx]
        validity = None if self.validity is None \
            else np.asarray(self.validity)[idx]
        if self.dictionary is not None:
            return Column(self.dtype, vals.astype(np.int32), validity,
                          DICT, dictionary=self.dictionary)
        return Column(self.dtype, vals, validity, PLAIN)

    def with_values(self, values, validity="__keep__") -> "Column":
        v = self.validity if validity == "__keep__" else validity
        return replace(self, values=values, validity=v)

    def take(self, indices: np.ndarray) -> "Column":
        """Positional gather (reference ``Block.copyPositions:250``)."""
        if self.kind == RLE:
            return self.decode_runs().take(indices)
        out = replace(
            self,
            values=np.asarray(self.values)[indices],
            validity=None if self.validity is None else np.asarray(self.validity)[indices],
            lengths=None if self.lengths is None else np.asarray(self.lengths)[indices],
            values2=None if self.values2 is None else np.asarray(self.values2)[indices],
            children=None if self.children is None else [
                (f, c.take(indices)) for f, c in self.children],
        )
        return out

    def slice(self, start: int, count: int) -> "Column":
        """Region view (reference ``Block.getRegion:261``)."""
        if self.kind == RLE:
            return self.decode_runs().slice(start, count)
        sl = slice(start, start + count)
        return replace(
            self,
            values=self.values[sl],
            validity=None if self.validity is None else self.validity[sl],
            lengths=None if self.lengths is None else self.lengths[sl],
            values2=None if self.values2 is None else self.values2[sl],
            children=None if self.children is None else [
                (f, c.slice(start, count)) for f, c in self.children],
        )

    # ---- host-side materialization (testing / client output) ----

    def to_pylist(self):
        n = self.row_count
        valid = np.ones(n, dtype=bool) if self.validity is None else np.asarray(self.validity)
        out = []
        if self.kind == ROW:
            fields = [(f, c.to_pylist()) for f, c in self.children]
            return [{f: vals[i] for f, vals in fields} for i in range(n)]
        if self.kind == RLE:
            return self.decode_runs().to_pylist()
        if self.kind in (ARRAY, MAP):
            vals = np.asarray(self.values)
            lens = np.asarray(self.lengths)

            def elem(v, dtype, d):
                if d is not None and is_string(dtype):
                    return str(d[int(v)])
                return v.item()

            from .types import ArrayType, MapType
            if self.kind == ARRAY:
                et = self.dtype.element if isinstance(self.dtype, ArrayType) \
                    else self.dtype
                for i in range(n):
                    out.append([elem(v, et, self.dictionary)
                                for v in vals[i, :lens[i]]]
                               if valid[i] else None)
            else:
                v2 = np.asarray(self.values2)
                kt = self.dtype.key if isinstance(self.dtype, MapType) \
                    else self.dtype
                vt = self.dtype.value if isinstance(self.dtype, MapType) \
                    else self.dtype
                # map values decode through their OWN dictionary; falling
                # back to the key dictionary only for legacy single-dict
                # columns
                vdict = self.dictionary2 if self.dictionary2 is not None \
                    else self.dictionary
                for i in range(n):
                    out.append({elem(k, kt, self.dictionary):
                                elem(v, vt, vdict) for k, v in
                                zip(vals[i, :lens[i]], v2[i, :lens[i]])}
                               if valid[i] else None)
            return out
        if self.kind == DICT:
            codes = np.asarray(self.values)
            for i in range(n):
                out.append(str(self.dictionary[codes[i]]) if valid[i] else None)
        elif self.kind == BYTES:
            vals = np.asarray(self.values)
            lens = np.asarray(self.lengths)
            for i in range(n):
                out.append(
                    bytes(vals[i, : lens[i]]).decode("ascii", "replace") if valid[i] else None
                )
        else:
            vals = np.asarray(self.values)
            from .types import is_timestamp_tz
            if is_timestamp_tz(self.dtype):
                # render "yyyy-mm-dd hh:mm:ss.fff +hh:mm" (the client
                # protocol carries zoned timestamps as strings, like the
                # reference's protocol encoding)
                offs = (np.zeros(n, np.int64) if self.values2 is None
                        else np.asarray(self.values2))
                for i in range(n):
                    out.append(format_tstz(int(vals[i]), int(offs[i]),
                                           self.dtype.precision)
                               if valid[i] else None)
                return out
            if vals.dtype == object:  # long-decimal python ints
                for i in range(n):
                    out.append(vals[i] if valid[i] else None)
            else:
                for i in range(n):
                    out.append(vals[i].item() if valid[i] else None)
        return out


def rle_column(dtype: DataType, run_values, run_lengths, validity=None,
               dictionary=None) -> Column:
    """Run-length column: ``run_values[i]`` repeats ``run_lengths[i]``
    times.  Constant columns are the 1-run case (the reference's
    ``RunLengthEncodedBlock``); ``validity`` is per-RUN."""
    return Column(
        dtype=dtype,
        values=np.asarray(run_values),
        validity=None if validity is None else np.asarray(validity),
        kind=RLE,
        lengths=np.asarray(run_lengths, dtype=np.int64),
        dictionary=None if dictionary is None
        else np.asarray(dictionary, dtype=object),
    )


def row_column(fields) -> Column:
    """Assemble a ROW-kind host column from [(field_name, Column)]."""
    from .types import RowType
    assert fields, "row column needs at least one field"
    n = fields[0][1].row_count
    return Column(
        dtype=RowType(tuple((f, c.dtype) for f, c in fields)),
        values=np.zeros(n, np.bool_),   # placeholder for row_count only
        kind=ROW,
        children=list(fields),
    )


def format_tstz(utc_micros: int, offset_min: int, precision: int = 3) -> str:
    """Render a zoned timestamp at its presentation offset."""
    import datetime as dt
    local = dt.datetime(1970, 1, 1) + dt.timedelta(
        microseconds=utc_micros + offset_min * 60_000_000)
    body = local.isoformat(" ")
    if "." not in body:
        body += "."
    head, frac = body.split(".")
    body = head if precision == 0 else f"{head}.{frac[:precision]:0<{precision}}"
    sign = "-" if offset_min < 0 else "+"
    h, m = divmod(abs(offset_min), 60)
    return f"{body} {sign}{h:02d}:{m:02d}"


def plain_column(dtype: DataType, values, validity=None) -> Column:
    return Column(dtype=dtype, values=values, validity=validity, kind=PLAIN)


def dict_column(dtype: DataType, codes, dictionary, validity=None) -> Column:
    assert is_string(dtype)
    return Column(
        dtype=dtype,
        values=np.asarray(codes, dtype=np.int32),
        validity=validity,
        kind=DICT,
        dictionary=np.asarray(dictionary, dtype=object),
    )


def bytes_column(dtype: DataType, strings=None, *, values=None, lengths=None, validity=None) -> Column:
    """Build a fixed-width bytes column from python strings or raw arrays."""
    assert is_string(dtype)
    if strings is not None:
        enc = [s.encode("ascii") for s in strings]
        width = max((len(b) for b in enc), default=1)
        if isinstance(dtype, (VarcharType, CharType)) and dtype.length:
            width = max(width, dtype.length)
        n = len(enc)
        values = np.zeros((n, width), dtype=np.uint8)
        lengths = np.zeros(n, dtype=np.int32)
        for i, b in enumerate(enc):
            values[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            lengths[i] = len(b)
    return Column(
        dtype=dtype,
        values=values,
        validity=validity,
        kind=BYTES,
        lengths=np.asarray(lengths, dtype=np.int32),
    )


def strings_from_bytes(values: np.ndarray, lengths: np.ndarray):
    """Decode a BYTES layout back to python strings (host side)."""
    return [bytes(values[i, : lengths[i]]).decode("ascii") for i in range(values.shape[0])]
