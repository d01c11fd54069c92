"""A two-line-header pipe table, as ``tabulate(..., tablefmt="pipe",
numalign="left")`` prints it; the port does not depend on tabulate."""

from __future__ import annotations


def pipe_table(rows, headers) -> str:
    """rows: lists of cells (converted with ``str``); headers: their names.
    Every column is left-aligned and at least two wider than its header."""
    rows = [[str(c) for c in row] for row in rows]
    widths = [max([len(h) + 2] + [len(r[i]) for r in rows]) for i, h in enumerate(headers)]
    line = lambda cells: "| " + " | ".join(c.ljust(w) for c, w in zip(cells, widths)) + " |"  # noqa: E731
    rule = "|" + "|".join(":" + "-" * (w + 1) for w in widths) + "|"
    return "\n".join([line(headers), rule] + [line(r) for r in rows])
