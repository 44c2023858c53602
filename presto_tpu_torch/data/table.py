"""Table: an ordered set of equal-length Columns.

The host-side analogue of an accumulated sequence of Trino Pages
(``core/trino-spi/src/main/java/io/trino/spi/Page.java:33``): the engine's
scan layer slices row-ranges of a Table into device-resident batches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from .column import Column


@dataclass
class Table:
    columns: Dict[str, Column] = field(default_factory=dict)

    @property
    def row_count(self) -> int:
        for c in self.columns.values():
            return c.row_count
        return 0

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def select(self, names) -> "Table":
        return Table({n: self.columns[n] for n in names})

    def slice(self, start: int, count: int) -> "Table":
        return Table({n: c.slice(start, count) for n, c in self.columns.items()})

    def take(self, indices: np.ndarray) -> "Table":
        return Table({n: c.take(indices) for n, c in self.columns.items()})

    def to_pydict(self):
        return {n: c.to_pylist() for n, c in self.columns.items()}

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_pydict())
