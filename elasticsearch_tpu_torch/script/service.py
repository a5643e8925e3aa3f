"""ScriptService: stored scripts and script specs (port of
`elasticsearch_tpu/script/service.py`).

Stored scripts (`_scripts/{id}`) are addressed by id from any
`"script": {"id": ...}` spec and from search templates; `resolve()` turns
a spec (a string, an inline `source` or a stored `id`) into its language,
source and params, and every caller (`script_score`, `script_fields`,
`_update` scripts, search templates) goes through it. The languages are
Painless (`script/painless.py`, with the batched expression path of
`search/script_score.py`) and mustache (`script/mustache.py`).

The reference keeps stored scripts in cluster state, one process-wide
registry shared by its nodes, persisted under the last node's data path.
The port keeps a registry of its own (`GLOBAL_SCRIPTS` here), shared by
the port's nodes of a process and never the reference's; it has no
durability (nothing of the port persists across processes).
"""

from __future__ import annotations

import ast
import json
from typing import Any, Dict

from elasticsearch_tpu_torch.common.errors import (
    IllegalArgumentError, ParsingError, ResourceNotFoundError,
)

# the languages the service accepts; painless is the default
SUPPORTED_LANGS = ("painless", "mustache", "expression")


class StoredScript:
    def __init__(self, lang: str, source: str):
        if lang not in SUPPORTED_LANGS:
            raise IllegalArgumentError(
                f"unable to parse unsupported lang [{lang}]")
        self.lang = lang
        self.source = source

    def to_dict(self) -> dict:
        return {"lang": self.lang, "source": self.source}


class ScriptService:
    """The stored-script registry and the resolution of script specs."""

    def __init__(self):
        self._stored: Dict[str, StoredScript] = {}

    def clear(self) -> None:
        """Drop every stored script."""
        self._stored.clear()

    # -- stored scripts (`_scripts/{id}`) -----------------------------------
    def put_stored(self, script_id: str, body: dict) -> None:
        spec = body.get("script")
        if not isinstance(spec, dict) or "source" not in spec:
            raise ParsingError("stored script must define [script.source]")
        lang = spec.get("lang", "painless")
        source = spec["source"]
        if not isinstance(source, str):
            source = json.dumps(source)
        script = StoredScript(lang, source)
        self._compile_check(script)
        self._stored[script_id] = script

    def get_stored(self, script_id: str) -> StoredScript:
        if script_id not in self._stored:
            raise ResourceNotFoundError(
                f"stored script [{script_id}] not found")
        return self._stored[script_id]

    def delete_stored(self, script_id: str) -> None:
        if script_id not in self._stored:
            raise ResourceNotFoundError(
                f"stored script [{script_id}] not found")
        del self._stored[script_id]

    def _compile_check(self, script: StoredScript) -> None:
        """Compile at store time, as the reference does: a mustache
        template parses; a Painless source parses as the reference checks
        it, as an expression, else as statements (`;` read as line
        ends)."""
        if script.lang == "mustache":
            from elasticsearch_tpu_torch.script import mustache
            mustache._Parser(script.source).parse()
            return
        try:
            ast.parse(script.source, mode="eval")
        except SyntaxError:
            try:
                ast.parse(_strip_semicolons(script.source), mode="exec")
            except SyntaxError as e:
                raise ParsingError(f"compile error: {e}")

    # -- spec resolution ----------------------------------------------------
    def resolve(self, spec: Any) -> dict:
        """A `"script"` value (a string, {source} or {id}) as {"lang",
        "source", "params"}."""
        if isinstance(spec, str):
            return {"lang": "painless", "source": spec, "params": {}}
        if not isinstance(spec, dict):
            raise ParsingError("script must be a string or object")
        params = spec.get("params", {})
        if "id" in spec:
            stored = self.get_stored(spec["id"])
            return {"lang": stored.lang, "source": stored.source,
                    "params": params}
        if "source" not in spec:
            raise ParsingError("script must define [source] or [id]")
        return {"lang": spec.get("lang", "painless"),
                "source": spec["source"], "params": params}

    # -- search templates ---------------------------------------------------
    def render_template(self, body: dict) -> dict:
        """`_render/template` / `_search/template`: the template (inline
        `source` or a stored `id`) rendered with `params` into a search
        body."""
        from elasticsearch_tpu_torch.script import mustache
        params = body.get("params", {})
        if "id" in body:
            source = self.get_stored(body["id"]).source
        else:
            source = body.get("source")
            if source is None:
                raise ParsingError(
                    "search template must define [source] or [id]")
        return mustache.render_search_template(source, params)


def _strip_semicolons(source: str) -> str:
    """Painless statements end with `;`: one a line for the check."""
    return "\n".join(s.strip() for s in source.split(";") if s.strip())


def resolve_stored(spec: Any, context: str) -> Any:
    """A stored-script reference ({id} without source) as the inline spec
    {source, params}; a mustache template is refused, as the reference
    refuses it in `context` ("usable in this context", "usable as an
    update script"). Any other spec is returned as given."""
    if isinstance(spec, dict) and "id" in spec and "source" not in spec:
        resolved = GLOBAL_SCRIPTS.resolve(spec)
        if resolved["lang"] == "mustache":
            raise IllegalArgumentError(
                f"stored script [{spec['id']}] is a [mustache] template, "
                f"not {context}")
        return {"source": resolved["source"],
                "params": spec.get("params", {})}
    return spec


# the port's stored scripts, shared by its nodes in a process
GLOBAL_SCRIPTS = ScriptService()
