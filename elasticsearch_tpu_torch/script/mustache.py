"""Mustache template rendering for search templates (port of
`elasticsearch_tpu/script/mustache.py`, the same names).

Reference: `modules/lang-mustache` (2.1k LoC) — Elasticsearch embeds the
Mustache engine to render `_search/template` bodies before parsing them as
query DSL. This is a self-contained renderer covering the subset the
reference's search templates exercise: `{{var}}` interpolation with
dotted-path lookup, triple-stash `{{{var}}}` (no escaping — ES renders into
JSON, not HTML, so both forms are unescaped here too), sections
`{{#x}}...{{/x}}` over lists / truthy values, inverted sections `{{^x}}`,
comments `{{! }}`, and the ES custom lambdas `{{#toJson}}field{{/toJson}}`,
`{{#join}}field{{/join}}` (`CustomMustacheFactory.java` in the reference
module registers toJson/join encoders).
"""

from __future__ import annotations

import json
import re
from typing import Any, List

from elasticsearch_tpu_torch.common.errors import ParsingError

# Triple-stash must be matched as an alternative, not with optional braces —
# otherwise `{{n}}}` (a tag followed by the surrounding JSON's own `}`)
# greedily consumes three closing braces.
_TAG = re.compile(
    r"\{\{\{\s*([^}]*?)\s*\}\}\}"            # {{{ var }}}
    r"|\{\{\s*([#/^!&]?)\s*([^}]*?)\s*\}\}"  # {{ sigil name }}
)


def _lookup(context_stack: List[Any], path: str) -> Any:
    if path == ".":
        return context_stack[-1]
    parts = path.split(".")
    for ctx in reversed(context_stack):
        cur = ctx
        found = True
        for p in parts:
            if isinstance(cur, dict) and p in cur:
                cur = cur[p]
            else:
                found = False
                break
        if found:
            return cur
    return None


def _stringify(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    return str(v)


class _Parser:
    """Tokenizes a template into a tree of (text | var | section) nodes."""

    def __init__(self, template: str):
        self.template = template

    def parse(self) -> list:
        nodes, rest = self._parse_block(0, None)
        if rest != len(self.template):
            raise ParsingError("unbalanced mustache section close tag")
        return nodes

    def _parse_block(self, pos: int, open_name: str | None):
        nodes: list = []
        tmpl = self.template
        while pos < len(tmpl):
            m = _TAG.search(tmpl, pos)
            if m is None:
                nodes.append(("text", tmpl[pos:]))
                return nodes, len(tmpl)
            if m.start() > pos:
                nodes.append(("text", tmpl[pos:m.start()]))
            if m.group(1) is not None:          # triple-stash variable
                sigil, name = "", m.group(1)
            else:
                sigil, name = m.group(2), m.group(3)
            pos = m.end()
            if sigil == "!":
                continue
            if sigil in ("#", "^"):
                body, pos = self._parse_block(pos, name)
                nodes.append(("section" if sigil == "#" else "inverted",
                              name, body))
            elif sigil == "/":
                if name != open_name:
                    raise ParsingError(
                        f"mustache section mismatch: open [{open_name}] "
                        f"closed by [{name}]")
                return nodes, pos
            else:
                nodes.append(("var", name))
        if open_name is not None:
            raise ParsingError(f"unclosed mustache section [{open_name}]")
        return nodes, pos


def _render_nodes(nodes: list, stack: List[Any], out: List[str]) -> None:
    for node in nodes:
        kind = node[0]
        if kind == "text":
            out.append(node[1])
        elif kind == "var":
            out.append(_stringify(_lookup(stack, node[1])))
        elif kind == "section":
            name, body = node[1], node[2]
            if name == "toJson":
                inner: List[str] = []
                _render_nodes(body, stack, inner)
                out.append(json.dumps(_lookup(stack, "".join(inner).strip())))
                continue
            if name == "join":
                inner = []
                _render_nodes(body, stack, inner)
                val = _lookup(stack, "".join(inner).strip())
                if isinstance(val, list):
                    out.append(",".join(_stringify(v) for v in val))
                else:
                    out.append(_stringify(val))
                continue
            val = _lookup(stack, name)
            if isinstance(val, list):
                for item in val:
                    stack.append(item)
                    _render_nodes(body, stack, out)
                    stack.pop()
            elif isinstance(val, dict):
                stack.append(val)
                _render_nodes(body, stack, out)
                stack.pop()
            elif val:
                _render_nodes(body, stack, out)
        elif kind == "inverted":
            name, body = node[1], node[2]
            val = _lookup(stack, name)
            if not val or (isinstance(val, list) and not val):
                _render_nodes(body, stack, out)


def render(template: str, params: dict | None) -> str:
    """Render a mustache template with params; returns the raw string."""
    nodes = _Parser(template).parse()
    out: List[str] = []
    _render_nodes(nodes, [params or {}], out)
    return "".join(out)


def render_search_template(source: Any, params: dict | None) -> dict:
    """Render a search-template source (string or dict) into a request body.

    The reference serializes a dict source back to JSON before rendering
    (`TransportRenderSearchTemplateAction`), so both forms funnel through
    the string path.
    """
    if isinstance(source, dict):
        source = json.dumps(source)
    rendered = render(source, params)
    try:
        return json.loads(rendered)
    except ValueError as e:
        raise ParsingError(
            f"rendered search template is not valid JSON: {e}: {rendered[:200]}")
