"""Device-resident columnar values + chunk container.

Torch port of ``presto_tpu/exec/columns.py``, the runtime analogue of the
reference's Page/Block (``core/trino-spi/.../spi/Page.java:33``): a ``DCol``
is one column's tensors plus static metadata; a ``Chunk`` is an
equal-length set of DCols with a row-validity mask (selection is a mask;
compaction is an explicit operator step).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Optional

import numpy as np
import torch

from ..data import types as T
from ..data.column import Column, PLAIN, DICT, BYTES


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
    kind: str                      # PLAIN | DICT | BYTES
    values: torch.Tensor           # PLAIN:[N] (long decimal [N,2]) | DICT codes:[N] | BYTES:[N,W]
    lengths: Optional[torch.Tensor] = None   # BYTES
    validity: Optional[torch.Tensor] = None  # bool [N]; None = all valid
    dictionary: Optional[Dictionary] = None  # DICT

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
                    v, self.dictionary)


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
    if col.kind != PLAIN:
        raise NotImplementedError(f"{col.kind} columns on the torch path")
    return DCol(col.dtype, PLAIN, _dev(col.values, device), None, validity)


def to_host(col: DCol, sel: np.ndarray) -> Column:
    """Materialise selected row indices back into a host Column."""
    vals = col.values.cpu().numpy()[sel]
    validity = None if col.validity is None else \
        col.validity.cpu().numpy()[sel]
    if col.kind == DICT:
        return Column(col.dtype, vals.astype(np.int32), validity, DICT,
                      dictionary=col.dictionary.strings)
    if col.kind == BYTES:
        return Column(col.dtype, vals, validity, BYTES,
                      lengths=col.lengths.cpu().numpy()[sel])
    if vals.ndim == 2 and T.is_decimal(col.dtype):
        # long decimal (hi, lo) words → exact python ints
        from ..ops.int128 import to_host_ints
        return Column(col.dtype, to_host_ints(vals), validity, PLAIN)
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
    ``values``, ``lengths``, ``validity``, ``dictionary`` with array-like
    members) → this package's DCol on ``device``, through numpy.  Feeds
    both engines identical inputs in the tests."""
    def arr(a):
        return None if a is None else _dev(np.asarray(a), device)
    d = None if other.dictionary is None else \
        Dictionary(other.dictionary.strings)
    return DCol(_port_type(other.dtype), other.kind, arr(other.values),
                arr(other.lengths), arr(other.validity), d)
