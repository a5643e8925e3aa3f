"""Run the port's REST server.

    python -m elasticsearch_tpu_torch.server --port 9200 --device cuda

`--device cpu` serves through the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse

from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.rest.actions import register_all
from elasticsearch_tpu_torch.rest.controller import RestController
from elasticsearch_tpu_torch.rest.http_server import HttpServer


def build_server(device="cuda", host: str = "127.0.0.1", port: int = 9200,
                 settings=None):
    """(node, server) wired together, the node made with `settings` (flat
    node settings such as `search.request_cache.device_paths`); the
    caller starts and stops the server."""
    node = Node(device=device, settings=settings)
    rc = RestController()
    register_all(rc, node)
    return node, HttpServer(rc, host=host, port=port)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9200)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    _, server = build_server(args.device, args.host, args.port)
    print(f"listening on http://{server.host}:{server.port} "
          f"(device {args.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
