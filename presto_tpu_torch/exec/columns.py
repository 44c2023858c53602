"""Device-resident columnar values + chunk container.

Torch port of ``presto_tpu/exec/columns.py``, the runtime analogue of the
reference's Page/Block (``core/trino-spi/.../spi/Page.java:33``): a ``DCol``
is one column's tensors plus static metadata; a ``Chunk`` is an
equal-length set of DCols with a row-validity mask (selection is a mask;
compaction is an explicit operator step).

Nested values: an ARRAY column is ``values [N, W]`` of its element's
physical dtype (a string element is a code into ``dictionary``) and
``lengths [N]``; a MAP adds its values as ``values2 [N, W]`` (a string
map value is a code into ``dictionary2``, the keys' strings staying in
``dictionary``).  W is the column's widest row; positions past a row's
length are padding.  ROW values never reach the device: the planner
shreds them into one column per field.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Optional

import numpy as np
import torch

from ..data import types as T
from ..data.column import Column, PLAIN, DICT, BYTES, ARRAY, MAP
from ..utils.tracing import host_read


class Dictionary:
    """Interned host-side string dictionary (equal by identity)."""

    __slots__ = ("strings",)

    def __init__(self, strings: np.ndarray):
        self.strings = np.asarray(strings, dtype=object)

    def __len__(self):
        return len(self.strings)

    def __getitem__(self, i):
        return self.strings[i]

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@dataclass
class DCol:
    dtype: T.DataType
    kind: str                      # PLAIN | DICT | BYTES | ARRAY | MAP
    # PLAIN:[N] (long decimal [N,2]) | DICT codes:[N] | BYTES, ARRAY,
    # MAP keys:[N,W]
    values: torch.Tensor
    lengths: Optional[torch.Tensor] = None   # BYTES, ARRAY, MAP
    validity: Optional[torch.Tensor] = None  # bool [N]; None = all valid
    # DICT; a string element of an ARRAY, a string key of a MAP
    dictionary: Optional[Dictionary] = None
    # TIMESTAMP WITH TIME ZONE: int32 minutes east of UTC per row (values
    # hold the UTC instant in int64 micros); MAP: its values [N, W]
    values2: Optional[torch.Tensor] = None
    dictionary2: Optional[Dictionary] = None  # MAP: string map values

    @property
    def n_rows(self) -> int:
        return int(self.values.shape[0])

    def valid_or_true(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones((self.values.shape[0],), dtype=torch.bool,
                              device=self.values.device)
        return self.validity

    def take(self, idx: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> "DCol":
        """Gather rows by index (clamped into range, as JAX gathers clamp);
        optional extra validity for padded gathers."""
        i = idx.to(torch.int64).clamp(0, self.values.shape[0] - 1)
        v = None if self.validity is None else self.validity[i]
        if valid is not None:
            v = valid if v is None else (v & valid)
        return DCol(self.dtype, self.kind, self.values[i],
                    None if self.lengths is None else self.lengths[i],
                    v, self.dictionary,
                    None if self.values2 is None else self.values2[i],
                    self.dictionary2)


@dataclass
class Chunk:
    """Equal-length device columns + row mask."""

    cols: Dict[str, DCol]
    mask: torch.Tensor  # bool [N]

    @property
    def n_rows(self) -> int:
        return int(self.mask.shape[0])


def _dev(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch tensors may not alias read-only memory
        a = a.copy()
    return torch.from_numpy(a).to(device)


def from_host(col: Column, device) -> DCol:
    """Host Column → DCol on ``device`` (RLE columns expand there)."""
    if col.kind == "rle":
        # run-length upload: move R runs, expand on the device
        reps = _dev(np.asarray(col.lengths, dtype=np.int64), device)
        vals = torch.repeat_interleave(_dev(col.values, device), reps)
        validity = None if col.validity is None else \
            torch.repeat_interleave(_dev(col.validity, device), reps)
        if col.dictionary is not None:
            return DCol(col.dtype, DICT, vals.to(torch.int32), None,
                        validity, Dictionary(col.dictionary))
        return DCol(col.dtype, PLAIN, vals, None, validity)
    validity = None if col.validity is None else _dev(col.validity, device)
    if col.kind == DICT:
        return DCol(col.dtype, DICT, _dev(col.values, device), None, validity,
                    Dictionary(col.dictionary))
    if col.kind == BYTES:
        return DCol(col.dtype, BYTES, _dev(col.values, device),
                    _dev(col.lengths, device), validity)
    if col.kind in (ARRAY, MAP):
        return DCol(col.dtype, col.kind, _dev(col.values, device),
                    _dev(col.lengths, device), validity,
                    None if col.dictionary is None
                    else Dictionary(col.dictionary),
                    None if col.values2 is None
                    else _dev(col.values2, device),
                    None if col.dictionary2 is None
                    else Dictionary(col.dictionary2))
    if col.kind != PLAIN:
        raise NotImplementedError(f"{col.kind} columns on the torch path")
    values = col.values
    if T.is_long_decimal(col.dtype) and np.asarray(values).ndim == 1:
        # exact python ints (a materialised long decimal, e.g. a memory
        # table's column) → (hi, lo) words
        from ..ops.int128 import from_host_ints
        values = from_host_ints(values)
    values2 = None if col.values2 is None else _dev(col.values2, device)
    return DCol(col.dtype, PLAIN, _dev(values, device), None, validity,
                values2=values2)


def to_host(col: DCol, sel: np.ndarray, ctx=None) -> Column:
    """Materialise selected row indices back into a host Column: one
    device→host read per tensor of the column, each counted on
    ``ctx.host_syncs`` (``utils/tracing.host_read``)."""
    def read(t: torch.Tensor) -> np.ndarray:
        with host_read(ctx):
            host = t.cpu().numpy()
        return host[sel]

    vals = read(col.values)
    validity = None if col.validity is None else read(col.validity)
    if col.kind == DICT:
        return Column(col.dtype, vals.astype(np.int32), validity, DICT,
                      dictionary=col.dictionary.strings)
    if col.kind == BYTES:
        return Column(col.dtype, vals, validity, BYTES,
                      lengths=read(col.lengths))
    if col.kind in (ARRAY, MAP):
        return Column(col.dtype, vals, validity, col.kind,
                      dictionary=None if col.dictionary is None
                      else col.dictionary.strings,
                      lengths=read(col.lengths),
                      values2=None if col.values2 is None
                      else read(col.values2),
                      dictionary2=None if col.dictionary2 is None
                      else col.dictionary2.strings)
    if vals.ndim == 2 and T.is_decimal(col.dtype):
        # long decimal (hi, lo) words → exact python ints
        from ..ops.int128 import to_host_ints
        return Column(col.dtype, to_host_ints(vals), validity, PLAIN)
    if col.values2 is not None:  # a zoned timestamp's offsets
        return Column(col.dtype, vals, validity, PLAIN,
                      values2=read(col.values2))
    return Column(col.dtype, vals, validity, PLAIN)


def _port_type(t):
    """A type object of another package's ``data.types`` (same class
    names and fields) → this package's."""
    if isinstance(t, (list, tuple)):
        return type(t)(_port_type(x) for x in t)
    if not hasattr(t, "__dataclass_fields__"):
        return t
    cls = getattr(T, type(t).__name__)
    return cls(**{f.name: _port_type(getattr(t, f.name))
                  for f in fields(t) if f.init})


def dcol_from_arrays(other, device) -> DCol:
    """Another engine's device column (duck-typed: ``dtype``, ``kind``,
    ``values``, ``lengths``, ``validity``, ``dictionary``, ``values2``,
    ``dictionary2`` with array-like members) → this package's DCol on
    ``device``, through numpy.  Feeds both engines identical inputs in
    the tests."""
    def arr(a):
        return None if a is None else _dev(np.asarray(a), device)

    def dic(d):
        return None if d is None else Dictionary(d.strings)
    return DCol(_port_type(other.dtype), other.kind, arr(other.values),
                arr(other.lengths), arr(other.validity),
                dic(other.dictionary), arr(getattr(other, "values2", None)),
                dic(getattr(other, "dictionary2", None)))
