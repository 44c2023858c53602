"""Interactive SQL REPL (the ``client/trino-cli`` Console analogue).

Usage:  python -m presto_tpu_torch.client.cli [--schema tiny|sf1|...]
            [--sf N] [--device cuda|cpu] [-e SQL | --serve PORT]

Torch port of ``presto_tpu/client/cli.py``.  ``--device`` defaults to
``cuda``; without a card the CLI exits non-zero with the no-CUDA-device
error unless it is given ``--device cpu`` (the counterpart of the JAX
package's ``PRESTO_TPU_PLATFORM=cpu``).
"""

from __future__ import annotations

import argparse
import sys
import time


def type_args(dtype: str) -> list:
    """The top-level arguments of a parametrised type's name:
    ``map(varchar(25),decimal(15,2))`` → ``["varchar(25)",
    "decimal(15,2)"]``; a ``row(...)`` gives its ``"name type"`` fields."""
    inner = dtype[dtype.index("(") + 1:-1]
    out, depth, start = [], 0, 0
    for i, ch in enumerate(inner):
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            out.append(inner[start:i].strip())
            start = i + 1
    return out + [inner[start:].strip()]


def nested_items(v, dtype: str):
    """(kind, [(label, value, type)]) of an ARRAY, MAP or ROW value, its
    elements with their types' names; None for any other type."""
    if dtype.startswith("array("):
        (et,) = type_args(dtype)
        return "array", [(None, x, et) for x in v]
    if dtype.startswith("map("):
        kt, vt = type_args(dtype)
        return "map", [((k, kt), x, vt) for k, x in v.items()]
    if dtype.startswith("row("):
        fields = [f.split(" ", 1) for f in type_args(dtype)]
        return "row", [(n, v[n], t) for n, t in fields]
    return None


def _fmt(v, dtype: str):
    """Render logical values: dates ISO, decimals with their scale,
    timestamps ISO (the client protocol keeps raw unscaled ints); an
    ARRAY as ``[a, b]``, a MAP as ``{k=v}`` and a ROW as ``{name=v}``,
    as Trino's CLI prints them."""
    if v is None:
        return "NULL"
    nested = nested_items(v, dtype)
    if nested is not None:
        kind, items = nested
        if kind == "array":
            return "[" + ", ".join(_fmt(x, t) for _, x, t in items) + "]"
        return "{" + ", ".join(
            f"{_fmt(*k) if kind == 'map' else k}={_fmt(x, t)}"
            for k, x, t in items) + "}"
    if dtype == "date":
        import datetime as dt
        return (dt.date(1970, 1, 1) + dt.timedelta(days=int(v))).isoformat()
    if dtype == "timestamp" or dtype.startswith("timestamp("):
        import datetime as dt
        out = (dt.datetime(1970, 1, 1)
               + dt.timedelta(microseconds=int(v))).isoformat(" ")
        if dtype.startswith("timestamp("):
            p = int(dtype.rstrip(")").split("(")[1])
            if "." in out:
                head, frac = out.split(".")
                out = head if p == 0 else f"{head}.{frac[:p]:0<{p}}"
        return out
    if dtype == "interval day to second":
        sign = "-" if v < 0 else ""
        us = abs(int(v))
        d, rem = divmod(us, 86_400_000_000)
        h, rem = divmod(rem, 3_600_000_000)
        m, rem = divmod(rem, 60_000_000)
        s_, ms = divmod(rem, 1_000_000)
        return f"{sign}{d} {h:02d}:{m:02d}:{s_:02d}.{ms // 1000:03d}"
    if dtype == "interval year to month":
        sign = "-" if v < 0 else ""
        y, mo = divmod(abs(int(v)), 12)
        return f"{sign}{y}-{mo}"
    if dtype.startswith("decimal("):
        scale = int(dtype.rstrip(")").split(",")[1])
        if scale == 0:
            return str(v)
        sign = "-" if v < 0 else ""
        a = abs(int(v))
        return f"{sign}{a // 10**scale}.{a % 10**scale:0{scale}d}"
    return str(v)


def format_table(names, rows, max_rows=100, types=None):
    types = types or ["" for _ in names]
    cols = [[str(n)] + [_fmt(v, types[i])
                        for v in (r[i] for r in rows[:max_rows])]
            for i, n in enumerate(names)]
    widths = [max(len(x) for x in c) for c in cols]
    sep = "-+-".join("-" * w for w in widths)
    out = [" | ".join(n.ljust(w) for n, w in zip(
        [c[0] for c in cols], widths)), sep]
    for i in range(min(len(rows), max_rows)):
        out.append(" | ".join(c[i + 1].ljust(w)
                              for c, w in zip(cols, widths)))
    if len(rows) > max_rows:
        out.append(f"... ({len(rows) - max_rows} more rows)")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="presto-tpu-torch")
    ap.add_argument("--schema", default="tiny")
    ap.add_argument("--sf", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (cuda or cpu)")
    ap.add_argument("-e", "--execute", default=None,
                    help="execute one statement and exit")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve the REST statement protocol instead of a "
                         "REPL (the coordinator HTTP surface)")
    args = ap.parse_args(argv)

    from .api import connect
    try:
        conn = connect(schema=args.schema, scale_factor=args.sf,
                       device=args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.serve is not None:
        from .server import StatementServer
        srv = StatementServer(conn, port=args.serve)
        print(f"serving statement protocol at {srv.url}/v1/statement")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            srv.close()
        return 0

    def run(sql: str) -> bool:
        t0 = time.time()
        try:
            cur = conn.execute(sql)
        except Exception as e:  # noqa: BLE001
            print(f"error: {e}", file=sys.stderr)
            return False
        rows = cur.fetchall()
        names = [d[0] for d in cur.description or []]
        types = [d[1] or "" for d in cur.description or []]
        print(format_table(names, rows, types=types))
        print(f"({len(rows)} rows in {time.time() - t0:.2f}s)")
        return True

    if args.execute:
        return 0 if run(args.execute) else 1

    print(f"presto_tpu_torch CLI — schema {args.schema}"
          f"{'' if args.sf is None else f' (sf={args.sf})'} on "
          f"{conn._runner.device}; "
          "end statements with ';', \\q to quit")
    buf = []
    while True:
        try:
            line = input("tpu> " if not buf else "  -> ")
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if line.strip() in ("\\q", "quit", "exit"):
            return 0
        buf.append(line)
        if line.rstrip().endswith(";"):
            run("\n".join(buf))
            buf = []


if __name__ == "__main__":
    sys.exit(main())
