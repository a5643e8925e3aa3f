"""Scripting (port of `elasticsearch_tpu/script/`): the stored-script
service (`service.py`), the sandboxed Painless interpreter
(`painless.py`) and the mustache renderer of search templates
(`mustache.py`). The port keeps its own registry of stored scripts."""

from elasticsearch_tpu_torch.script.service import ScriptService, StoredScript

__all__ = ["ScriptService", "StoredScript"]
