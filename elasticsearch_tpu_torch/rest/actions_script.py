"""REST handlers of stored scripts and search templates (port of
`elasticsearch_tpu/rest/actions_script.py`).

PUT|POST|GET|DELETE /_scripts/{id}; GET|POST [/{index}]/_search/template,
GET|POST /_render/template[/{id}] and GET|POST
[/{index}]/_msearch/template (NDJSON header / template pairs, an error
answering its own entry), through the node's script service
(`script/service.py`) and `Node.search_template` /
`Node.msearch_template`.
"""

from __future__ import annotations

from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.controller import RestController


def register_script(rc: RestController, node: Node) -> None:
    # --------------------------------------------------------- stored scripts
    def put_script(req):
        node.scripts.put_stored(req.params["id"], req.json() or {})
        return 200, {"acknowledged": True}

    def get_script(req):
        script = node.scripts.get_stored(req.params["id"])
        return 200, {"_id": req.params["id"], "found": True,
                     "script": script.to_dict()}

    def delete_script(req):
        node.scripts.delete_stored(req.params["id"])
        return 200, {"acknowledged": True}

    rc.register("PUT", "/_scripts/{id}", put_script)
    rc.register("POST", "/_scripts/{id}", put_script)
    rc.register("GET", "/_scripts/{id}", get_script)
    rc.register("DELETE", "/_scripts/{id}", delete_script)

    # ------------------------------------------------------- search templates
    def search_template(req):
        return 200, node.search_template(req.params.get("index"),
                                         req.json() or {})

    def render_template(req):
        body = req.json() or {}
        if "id" in req.params and "id" not in body:
            body["id"] = req.params["id"]
        return 200, {"template_output": node.scripts.render_template(body)}

    def msearch_template(req):
        return 200, node.msearch_template(req.ndjson(),
                                          req.params.get("index"))

    for path in ("/_search/template", "/{index}/_search/template"):
        rc.register("GET", path, search_template)
        rc.register("POST", path, search_template)
    for path in ("/_render/template", "/_render/template/{id}"):
        rc.register("GET", path, render_template)
        rc.register("POST", path, render_template)
    for path in ("/_msearch/template", "/{index}/_msearch/template"):
        rc.register("GET", path, msearch_template)
        rc.register("POST", path, msearch_template)
