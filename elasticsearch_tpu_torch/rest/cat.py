"""The `_cat` table renderer (port of `elasticsearch_tpu/rest/cat.py`, the
reference's RestTable contract):

- plain output has no header row; `v=true` adds one; `help=true` prints
  the column catalog (name | aliases | description) and no data;
- column widths come from the cell values, and from the header text only
  with `v=true`;
- numeric columns align right, text left; one space separates columns
  and every cell pads to its column's width but a last left-aligned one;
- `h=` selects and orders columns by name, alias or `*` pattern, a column
  asked for by an alias titled as asked;
- `s=` sorts rows by column (`:desc` reverses), numbers as numbers;
- `format=json` renders the selected columns as a list of objects;
- byte and millisecond cells take `bytes=` and human units otherwise.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple


class Col:
    def __init__(self, name: str, aliases: str = "", desc: str = "",
                 right: bool = False, default: bool = True):
        self.name = name
        self.aliases = [a for a in aliases.split(",") if a]
        self.desc = desc or name
        self.right = right
        self.default = default

    def matches(self, token: str) -> bool:
        t = token.lower()
        return t == self.name.lower() or t in (a.lower() for a in self.aliases)


class Bytes:
    """A byte-quantity cell: renders '12.1kb' style, or raw with bytes=b."""

    def __init__(self, n: Optional[int]):
        self.n = n

    _UNITS = {"b": 1, "k": 1024, "kb": 1024, "m": 1024 ** 2, "mb": 1024 ** 2,
              "g": 1024 ** 3, "gb": 1024 ** 3, "t": 1024 ** 4,
              "tb": 1024 ** 4, "p": 1024 ** 5, "pb": 1024 ** 5}

    def render(self, unit: Optional[str]) -> str:
        if self.n is None:
            return ""
        n = int(self.n)
        if unit in self._UNITS:
            # forced unit prints the integer quotient (ByteSizeValue.getGb)
            return str(n // self._UNITS[unit])
        for factor, suffix in ((1024 ** 5, "pb"), (1024 ** 4, "tb"),
                               (1024 ** 3, "gb"), (1024 ** 2, "mb"),
                               (1024, "kb")):
            if n >= factor:
                v = n / factor
                return f"{v:.1f}{suffix}".replace(".0" + suffix, suffix)
        return f"{n}b"

    def sort_key(self):
        return self.n if self.n is not None else -1


class Millis:
    """A duration cell: '123ms' under 1s else '1.2s' (TimeValue.toString)."""

    def __init__(self, ms: Optional[float]):
        self.ms = ms

    def render(self, unit: Optional[str]) -> str:
        if self.ms is None:
            return ""
        ms = float(self.ms)
        if ms < 1000:
            return f"{int(ms)}ms"
        if ms < 60_000:
            return f"{ms / 1000:.1f}s"
        return f"{ms / 60000:.1f}m"

    def sort_key(self):
        return self.ms if self.ms is not None else -1


def fmt_iso_millis(ms: int) -> str:
    """epoch-millis -> 2020-01-01T00:00:00.000Z (strict_date_time)."""
    import datetime
    return datetime.datetime.fromtimestamp(
        ms / 1000, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.") \
        + f"{int(ms) % 1000:03d}Z"


def _cell_str(v: Any, bytes_unit: Optional[str]) -> str:
    if v is None:
        return ""
    if isinstance(v, (Bytes, Millis)):
        return v.render(bytes_unit)
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return f"{v:.1f}"
    return str(v)


def _resolve_h(cols: Sequence[Col], h_param: Optional[str]) -> List[Tuple[int, str]]:
    """-> [(col_index, display_title)]; default = declared default columns."""
    if not h_param:
        return [(i, c.name) for i, c in enumerate(cols) if c.default]
    out = []
    for token in h_param.split(","):
        token = token.strip()
        if not token:
            continue
        if "*" in token:
            import fnmatch
            out.extend((i, c.name) for i, c in enumerate(cols)
                       if fnmatch.fnmatchcase(c.name, token))
            continue
        for i, c in enumerate(cols):
            if c.matches(token):
                out.append((i, token))
                break
    return out


def _sort_rows(cols: Sequence[Col], rows: List[list], s_param: Optional[str]):
    if not s_param:
        return rows
    keys = []
    for token in s_param.split(","):
        token = token.strip()
        desc = False
        if token.endswith(":desc"):
            token, desc = token[:-5], True
        elif token.endswith(":asc"):
            token = token[:-4]
        for i, c in enumerate(cols):
            if c.matches(token):
                keys.append((i, desc))
                break
    if not keys:
        return rows

    # stable multi-key sort: apply keys right-to-left
    for i, desc in reversed(keys):
        def single(row, i=i):
            v = row[i]
            if isinstance(v, (Bytes, Millis)):
                v = v.sort_key()
            if isinstance(v, bool):
                v = str(v)
            if isinstance(v, (int, float)):
                return (0, float(v), "")
            return (1, 0.0, str(v))
        rows = sorted(rows, key=single, reverse=desc)
    return rows


def render(req, cols: Sequence[Col], rows: List[list]) -> Tuple[int, Any]:
    """Format a cat table per the request's h/s/v/help/format/bytes params."""
    if req.param("help") in ("true", "", True):
        width = max((len(c.name) for c in cols), default=0)
        lines = [f"{c.name.ljust(width)} | {','.join(c.aliases) or '-':15s} | "
                 f"{c.desc}" for c in cols]
        return 200, "\n".join(lines) + "\n"
    bytes_unit = req.param("bytes")
    rows = _sort_rows(cols, list(rows), req.param("s"))
    selected = _resolve_h(cols, req.param("h"))
    if req.param("format") == "json":
        return 200, [
            {title: _cell_str(r[i], bytes_unit) for i, title in selected}
            for r in rows]
    verbose = req.param("v") in ("true", "", True)
    # stringify the selected grid
    grid = [[_cell_str(r[i], bytes_unit) for i, _ in selected] for r in rows]
    titles = [title for _, title in selected]
    widths = []
    for ci in range(len(selected)):
        w = max((len(g[ci]) for g in grid), default=0)
        if verbose:
            w = max(w, len(titles[ci]))
        widths.append(w)
    # RestTable.pad: every cell pads to the column width EXCEPT the last
    # column when left-aligned (the suites pin both `value\n` on a final
    # text column and leading spaces on a final right-aligned one)
    last = len(selected) - 1
    lines = []
    if verbose:
        hdr = [t.ljust(w) if ci != last else t
               for ci, (t, w) in enumerate(zip(titles, widths))]
        lines.append(" ".join(hdr))
    for g in grid:
        cells = []
        for ci, (i, _) in enumerate(selected):
            if cols[i].right:
                cells.append(g[ci].rjust(widths[ci]))
            elif ci != last:
                cells.append(g[ci].ljust(widths[ci]))
            else:
                cells.append(g[ci])
        lines.append(" ".join(cells))
    return 200, "\n".join(lines) + "\n"
