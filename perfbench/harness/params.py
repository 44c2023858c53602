"""The one traffic generator: a statement set's templates and the rules of
their substitution parameters.

A traffic file names its statement set and a ``parameter_pool`` of seeds:
one parameter set is drawn per pool seed, the same in every run, and the
run's ``--seed`` orders them (``parameter_sets``), so every seed does the
same timed work in another order. The run also draws a set from its own
``--seed`` (``draw_statements``), answered and checked after the window,
so every run compares parameters no run before it had.

A statement set (``reference/<name>.json``) holds named ``lists`` and, per
statement, its ``sql`` with ``{NAME}`` for each parameter and the ``params``
rules in the order they are drawn. A rule is a JSON object:

- ``{"int": [lo, hi]}``: a whole number, both ends included;
- ``{"pick": "LIST"}``: one entry of a named list;
- ``{"text": "..."}``: a fixed string (inside ``concat``);
- ``{"concat": [rule, ...], "sep": " "}``: the draws joined;
- ``{"distinct": rule, "n": k}`` / ``{"each": rule, "n": k}``: k draws of
  ``rule``, all different / independent; the SQL gets ``NAME1``..``NAMEk``
  and ``NAME`` (all of them joined by ", ");
- ``{"month": ["YYYY-MM", "YYYY-MM"]}``: the first day of a month;
  ``{"year": [y0, y1]}``: 1 January of a year; ``{"day": [iso, iso]}``: a
  day; each an ISO date;
- ``{"lookup": "NAME", "in": "MAP"}``: a named map's entry for a parameter
  drawn before;
- ``{"fraction": f, "digits": d}``: ``f / SF`` as a decimal literal with
  ``d`` digits; its value is ``[d, unscaled]``.

Any rule may add ``"sql": "format"``, applied to each value when the SQL
is written (``"0.{:02d}"`` writes 6 as ``0.06``). The reference receives
the values themselves.
"""

from __future__ import annotations

import datetime as dt
from typing import Dict, List, Tuple

import numpy as np


def _months(a: str, b: str) -> List[dt.date]:
    y, m = map(int, a.split("-"))
    end = tuple(map(int, b.split("-")))
    out = []
    while (y, m) <= end:
        out.append(dt.date(y, m, 1))
        y, m = (y + 1, 1) if m == 12 else (y, m + 1)
    return out


class Drawer:
    def __init__(self, lists: dict, sf: float, rng: np.random.Generator):
        self.lists, self.sf, self.rng = lists, sf, rng

    def _int(self, lo: int, hi: int) -> int:
        return int(self.rng.integers(lo, hi + 1))

    def draw(self, rule: dict, drawn: dict):
        if "int" in rule:
            return self._int(*rule["int"])
        if "pick" in rule:
            values = self.lists[rule["pick"]]
            return values[self._int(0, len(values) - 1)]
        if "text" in rule:
            return rule["text"]
        if "concat" in rule:
            return rule.get("sep", "").join(
                str(self.draw(r, drawn)) for r in rule["concat"])
        if "distinct" in rule:
            out: list = []
            while len(out) < rule["n"]:
                v = self.draw(rule["distinct"], drawn)
                if v not in out:
                    out.append(v)
            return out
        if "each" in rule:
            return [self.draw(rule["each"], drawn) for _ in range(rule["n"])]
        if "month" in rule:
            months = _months(*rule["month"])
            return months[self._int(0, len(months) - 1)].isoformat()
        if "year" in rule:
            return dt.date(self._int(*rule["year"]), 1, 1).isoformat()
        if "day" in rule:
            a, b = (dt.date.fromisoformat(x) for x in rule["day"])
            return (a + dt.timedelta(days=self._int(0, (b - a).days))
                    ).isoformat()
        if "lookup" in rule:
            return self.lists[rule["in"]][drawn[rule["lookup"]]]
        if "fraction" in rule:
            d = rule["digits"]
            return [d, int(round(rule["fraction"] / self.sf * 10 ** d))]
        raise ValueError(f"unknown parameter rule {rule}")


def _sql_value(rule: dict, value) -> str:
    if "fraction" in rule:
        d, unscaled = value
        q, r = divmod(unscaled, 10 ** d)
        return f"{q}.{r:0{d}d}"
    return rule.get("sql", "{}").format(value)


def render(sql: str, rules: dict, values: dict) -> str:
    """``sql`` with every ``{NAME}`` written from ``values``."""
    names = {}
    for name, rule in rules.items():
        v = values[name]
        if isinstance(v, list) and "fraction" not in rule:
            parts = [_sql_value(rule, x) for x in v]
            names[name] = ", ".join(parts)
            names.update({f"{name}{i + 1}": s for i, s in enumerate(parts)})
        else:
            names[name] = _sql_value(rule, v)
    return sql.format(**names)


def draw_statements(statements: dict, sf: float,
                    seed: int) -> Dict[str, Tuple[str, dict]]:
    """``{statement: (sql, parameter values)}``: one parameter set per
    seed, drawn statement by statement in the set's order."""
    rng = np.random.default_rng(int(seed) % 2**64)
    drawer = Drawer(statements["lists"], sf, rng)
    out = {}
    for name, st in statements["queries"].items():
        values: dict = {}
        for pname, rule in st["params"].items():
            values[pname] = drawer.draw(rule, values)
        out[name] = (render(st["sql"], st["params"], values), values)
    return out


def parameter_sets(statements: dict, traffic: dict, sf: float,
                   seed: int) -> List[Dict[str, Tuple[str, dict]]]:
    """The traffic's pool of parameter sets (one per pool seed, the same
    in every run), in the order the run's ``seed`` gives them."""
    pool = [draw_statements(statements, sf, s)
            for s in traffic["parameter_pool"]]
    order = np.random.default_rng(int(seed) % 2**64).permutation(len(pool))
    return [pool[i] for i in order]
