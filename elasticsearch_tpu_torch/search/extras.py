"""Suggesters (port of the suggester half of
`elasticsearch_tpu/search/extras.py`; `_rank_eval`, its other half, is
not ported).

- `term`: for each analyzed token absent from the field, the terms within
  `max_edits` (OSA distance, `search/queries.py::_fuzzy_terms`), scored
  1 - distance / longest length, then by frequency, then by text.
- `phrase`: the text with each absent token replaced by its best term
  suggestion, scored by the product of their scores.
- `completion`: on a `completion` field, one option a document (its best
  weighted input starting with the prefix, case folded), filtered by
  `category` and `geo` contexts, ranked by weight; on another field the
  prefix's terms ranked by frequency.

`execute_suggest` runs a body's `suggest` section over one index's reader;
the node merges the indices' options by score.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError,
)
from elasticsearch_tpu_torch.index.analysis import Token
from elasticsearch_tpu_torch.index.mapping import (
    CompletionFieldMapper, TextFieldMapper,
)
from elasticsearch_tpu_torch.search.queries import (
    SearchContext, _edit_distance_le, _fuzzy_terms, _pattern_terms,
    _prefix_select, _term_postings,
)

EARTH_RADIUS_M = 6371008.8


def _term_freq(ctx: SearchContext, field: str, term: str) -> int:
    return int(_term_postings(ctx, field, term)[1].sum())


def _candidates(ctx: SearchContext, field: str, token: str,
                max_edits: int = 2, size: int = 5) -> List[dict]:
    out = []
    for term in _fuzzy_terms(ctx, field, token, max_edits,
                             exclude_self=True):
        dist = 1 if _edit_distance_le(token, term, 1) else 2
        freq = _term_freq(ctx, field, term)
        score = 1.0 - dist / max(len(token), len(term), 1)
        out.append({"text": term, "score": round(score, 6), "freq": freq})
    out.sort(key=lambda c: (-c["score"], -c["freq"], c["text"]))
    return out[:size]


def term_suggest(ctx: SearchContext, text: str, field: str,
                 size: int = 5, max_edits: int = 2) -> List[dict]:
    mapper = ctx.mapper_service.get(field)
    if isinstance(mapper, TextFieldMapper):
        tokens = mapper.search_analyzer.analyze(str(text))
    else:
        tokens = [Token(str(text), 0, 0, len(str(text)))]
    entries = []
    for tok in tokens:
        exists = _term_freq(ctx, field, tok.term) > 0
        options = [] if exists else _candidates(ctx, field, tok.term,
                                                max_edits, size)
        entries.append({"text": tok.term, "offset": tok.start_offset,
                        "length": tok.end_offset - tok.start_offset,
                        "options": options})
    return entries


def phrase_suggest(ctx: SearchContext, text: str, field: str,
                   size: int = 3, max_edits: int = 2) -> List[dict]:
    entries = term_suggest(ctx, text, field, size=3, max_edits=max_edits)
    corrected = []
    any_correction = False
    score = 1.0
    for e in entries:
        if e["options"]:
            corrected.append(e["options"][0]["text"])
            score *= e["options"][0]["score"]
            any_correction = True
        else:
            corrected.append(e["text"])
    options = []
    if any_correction:
        options.append({"text": " ".join(corrected),
                        "score": round(score, 6)})
    return [{"text": text, "offset": 0, "length": len(text),
             "options": options}]


def haversine_m(lat1, lon1, lat2, lon2):
    """Great-circle distance in meters."""
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dp = p2 - p1
    dl = np.radians(lon2) - np.radians(lon1)
    a = np.sin(dp / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


_DIST_UNITS = {"m": 1.0, "meters": 1.0, "km": 1000.0, "kilometers": 1000.0,
               "mi": 1609.344, "miles": 1609.344, "yd": 0.9144, "ft": 0.3048,
               "in": 0.0254, "cm": 0.01, "mm": 0.001, "nmi": 1852.0,
               "nauticalmiles": 1852.0}


def parse_distance(v: Any) -> float:
    """'12km' → meters."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip().lower()
    for unit in sorted(_DIST_UNITS, key=len, reverse=True):
        if s.endswith(unit):
            return float(s[: -len(unit)]) * _DIST_UNITS[unit]
    return float(s)


# geohash level -> approximate cell size in meters
_GEOHASH_LEVEL_M = {1: 5_009_400.0, 2: 1_252_300.0, 3: 156_500.0,
                    4: 39_100.0, 5: 4_890.0, 6: 1_220.0, 7: 153.0,
                    8: 38.2, 9: 4.77, 10: 1.19, 11: 0.149, 12: 0.037}


def _parse_precision_m(precision) -> float:
    """A geo context's precision: an int is a geohash level (default 6),
    a string a distance."""
    if isinstance(precision, int) and not isinstance(precision, bool):
        return _GEOHASH_LEVEL_M.get(min(max(precision, 1), 12), 1_220.0)
    try:
        return parse_distance(precision)
    except Exception:
        raise IllegalArgumentError(
            f"invalid geo context precision [{precision}]")


def _contexts_match(ctx, row, entry, ctx_defs, query_contexts) -> bool:
    """Category: any queried value among the doc's values; geo: within the
    context's precision radius."""
    for name, want in query_contexts.items():
        cdef = next((d for d in ctx_defs if d.get("name") == name), None)
        if cdef is None:
            return False
        have = (entry.get("contexts") or {}).get(name)
        if have is None and cdef.get("path"):
            have = ctx.reader.get_doc_value(cdef["path"], int(row))
            if have is None:  # a dynamic text field keeps it in .keyword
                have = ctx.reader.get_doc_value(
                    f"{cdef['path']}.keyword", int(row))
        if have is None:
            return False
        if cdef.get("type") == "geo":
            specs = want if isinstance(want, list) else [want]
            point = have
            if isinstance(point, list) and point and \
                    isinstance(point[0], (list, tuple)):
                point = point[0]
            if isinstance(point, dict):
                plat, plon = float(point["lat"]), float(point["lon"])
            elif isinstance(point, (list, tuple)) and len(point) == 2:
                plat, plon = float(point[0]), float(point[1])
            else:
                return False
            radius = _parse_precision_m(cdef.get("precision", "5km"))
            ok = False
            for spec in specs:
                g = spec.get("context", spec) if isinstance(spec, dict) \
                    else {}
                if not isinstance(g, dict):
                    continue
                try:
                    if haversine_m(plat, plon, float(g["lat"]),
                                   float(g["lon"])) <= radius:
                        ok = True
                        break
                except (KeyError, TypeError, ValueError):
                    continue
            if not ok:
                return False
        else:  # category
            have_vals = have if isinstance(have, list) else [have]
            want_specs = want if isinstance(want, list) else [want]
            want_vals = [w.get("context") if isinstance(w, dict) else w
                         for w in want_specs]
            if not {str(v) for v in have_vals} & {str(v)
                                                  for v in want_vals}:
                return False
    return True


def completion_suggest(ctx: SearchContext, prefix: str, field: str,
                       size: int = 5, contexts=None,
                       index_name: str = "index",
                       skip_duplicates: bool = False) -> List[dict]:
    """Weight-ordered prefix matches over a completion field's inputs,
    one option a document, with context filtering and each option's
    `_id` and `_source`; on any other field the prefix's terms by
    frequency."""
    mapper = ctx.mapper_service.get(field)
    if not isinstance(mapper, CompletionFieldMapper):
        terms = _pattern_terms(ctx, field, _prefix_select(prefix))
        scored = [(t, _term_freq(ctx, field, t)) for t in terms]
        scored.sort(key=lambda kv: (-kv[1], kv[0]))
        return [{"text": prefix, "offset": 0, "length": len(prefix),
                 "options": [{"text": t, "_score": float(f)}
                             for t, f in scored[:size]]}]
    ctx_defs = list(mapper.params.get("contexts") or [])
    if ctx_defs:
        # the query must name at least one context value
        provided = {k: (v if isinstance(v, list) else [v])
                    for k, v in (contexts or {}).items()}
        if not any(vals for vals in provided.values()):
            raise IllegalArgumentError(
                "Missing mandatory contexts in context query")
    plc = str(prefix or "").lower()
    best_per_doc: Dict[int, Tuple[str, float]] = {}
    for row in ctx.all_rows():
        dv = ctx.reader.get_doc_value(field, int(row))
        if dv is None:
            continue
        for entry in (dv if isinstance(dv, list) else [dv]):
            if not isinstance(entry, dict):
                continue
            matched = [i for i in entry.get("input", [])
                       if str(i).lower().startswith(plc)]
            if not matched:
                continue
            if ctx_defs and contexts and not _contexts_match(
                    ctx, row, entry, ctx_defs, contexts):
                continue
            weight = float(entry.get("weight", 1))
            prev = best_per_doc.get(int(row))
            # one option a document: its best-weighted input
            if prev is None or weight > prev[1]:
                best_per_doc[int(row)] = (str(matched[0]), weight)
    ranked = sorted(best_per_doc.items(),
                    key=lambda kv: (-kv[1][1], kv[1][0]))
    if skip_duplicates:
        seen, deduped = set(), []
        for row, (text, weight) in ranked:
            if text not in seen:
                seen.add(text)
                deduped.append((row, (text, weight)))
        ranked = deduped
    options = [{"text": text, "_index": index_name,
                "_id": ctx.reader.get_id(row), "_score": weight,
                "_source": ctx.reader.get_source(row)}
               for row, (text, weight) in ranked[:size]]
    return [{"text": prefix, "offset": 0, "length": len(prefix),
             "options": options}]


def execute_suggest(ctx: SearchContext, spec: dict,
                    index_name: str = "index") -> Dict[str, list]:
    """A body's `suggest` section over one index: each named suggester's
    entries (the section's `text` is every suggester's default)."""
    out = {}
    global_text = spec.get("text")
    for name, body in spec.items():
        if name == "text" or not isinstance(body, dict):
            continue
        text = body.get("text", global_text)
        if "term" in body:
            t = body["term"]
            out[name] = term_suggest(ctx, text, t["field"],
                                     size=int(t.get("size", 5)),
                                     max_edits=int(t.get("max_edits", 2)))
        elif "phrase" in body:
            t = body["phrase"]
            out[name] = phrase_suggest(ctx, text, t["field"],
                                       size=int(t.get("size", 3)))
        elif "completion" in body:
            t = body["completion"]
            out[name] = completion_suggest(
                ctx, body.get("prefix", t.get("prefix", text)),
                t["field"], size=int(t.get("size", 5)),
                contexts=t.get("contexts"), index_name=index_name,
                skip_duplicates=bool(t.get("skip_duplicates", False)))
        else:
            raise ParsingError(f"unknown suggester in [{name}]")
    return out


def merge_suggest(merged: Dict[str, list], entries: Dict[str, list]) -> None:
    """One index's suggestions into the merged ones: a suggester's entries
    pairwise, their options by score, descending."""
    for name, got in entries.items():
        if name not in merged:
            merged[name] = got
            continue
        for a, b in zip(merged[name], got):
            a["options"] = sorted(
                a["options"] + b["options"],
                key=lambda o: -o.get("score", o.get("_score", 0.0)))
