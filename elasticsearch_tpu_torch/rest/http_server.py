"""HTTP/1.1 front for the RestController (port of
`elasticsearch_tpu/rest/http_server.py`), on the standard library's
threading HTTP server: one thread per connection, keep-alive, JSON bodies.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from elasticsearch_tpu_torch.rest.controller import RestController

MAX_BODY = 100 * 1024 * 1024  # http.max_content_length default


def _make_handler(controller: RestController):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # headers and body go out in two writes: without TCP_NODELAY the
        # second waits for the client's delayed ACK (~40 ms on loopback)
        disable_nagle_algorithm = True

        def _serve(self):
            parsed = urllib.parse.urlsplit(self.path)
            query = {k: v[-1] for k, v in urllib.parse.parse_qs(
                parsed.query, keep_blank_values=True).items()}
            length = int(self.headers.get("content-length") or 0)
            if length > MAX_BODY:
                self.send_error(413)
                return
            body = self.rfile.read(length) if length else b""
            headers = {k.lower(): v for k, v in self.headers.items()}
            status, payload = controller.dispatch(self.command, parsed.path,
                                                  query, body, headers)
            data = b"" if payload is None else json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("content-type", "application/json")
            self.send_header("content-length", str(len(data)))
            self.send_header("X-elastic-product", "Elasticsearch")
            self.end_headers()
            self.wfile.write(data)

        do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = _serve

        def log_message(self, fmt, *args):  # quiet: no per-request log line
            pass

    return Handler


class _Server(ThreadingHTTPServer):
    # the listen backlog: the standard library's 5 resets connections when
    # tens of clients connect at once (the reference's asyncio server
    # listens with 100)
    request_queue_size = 128


class HttpServer:
    """Serves `controller` on (host, port); port 0 picks a free port."""

    def __init__(self, controller: RestController, host: str = "127.0.0.1",
                 port: int = 9200):
        self._httpd = _Server((host, port), _make_handler(controller))
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Serve on a background thread."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="http-server", daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
