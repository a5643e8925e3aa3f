"""The host cost of the request telemetry on the machine it runs on: a
64-bit id from `uuid4` and from a process-local `random` generator, a
clock read, one trace of seven spans, and sequential HTTP searches of a
65,536 x 128 `flat` index (CPU, then CUDA) in blocks that alternate sample
rate 0 and 1.0 (8 blocks of 64). Run from the root of a checkout:

    python3 chip_probes/trace_cost.py

Prints one line a figure (µs, or the p50 ms of each rate).
"""
import os
import random
import statistics
import sys
import time
import timeit
import uuid

import numpy as np

sys.path.insert(0, os.getcwd())      # the checkout it runs in
import chip_smoke as cs  # noqa: E402
from elasticsearch_tpu_torch import telemetry  # noqa: E402
from elasticsearch_tpu_torch.server import build_server  # noqa: E402
from elasticsearch_tpu_torch.telemetry import trace  # noqa: E402


def micro() -> None:
    gen = random.Random()
    tracer = trace.Tracer(sample_rate=1.0)

    def one_trace():
        tr = tracer.start("a", "n", forced=True)
        with trace.use(trace=tr):
            for _ in range(6):
                trace.record_span("x", 100)
        tracer.finish(tr)

    for name, fn, n in (
            ("uuid4_us", lambda: uuid.uuid4().hex[:16], 20000),
            ("getrandbits_us", lambda: f"{gen.getrandbits(64):016x}", 20000),
            ("monotonic_ns_us", time.monotonic_ns, 20000),
            ("trace7_us", one_trace, 5000)):
        print(name, timeit.timeit(fn, number=n) / n * 1e6)


def http(device: str) -> None:
    node, server = build_server(device=device, port=0,
                                settings=cs.SERVE_SETTINGS)
    server.start()
    try:
        client = cs.Client(server.port)
        rng = np.random.default_rng(0)
        vecs = cs.clustered(rng, 65536, 128)
        client.ok("PUT", "/s", {"mappings": {"properties": {"vec": {
            "type": "dense_vector", "dims": 128, "similarity": "cosine"}}}})
        node.index("s").index_many([str(i) for i in range(len(vecs))],
                                   vectors={"vec": vecs})
        client.ok("POST", "/s/_refresh")
        bodies = [cs.knn_body("vec", q) for q in
                  rng.standard_normal((64, 128)).astype(np.float32)]
        lat = {0.0: [], 1.0: []}
        rate0 = telemetry.TRACER.sample_rate
        try:
            for block in range(8):
                for rate in (0.0, 1.0) if block % 2 == 0 else (1.0, 0.0):
                    telemetry.TRACER.configure(sample_rate=rate)
                    for body in bodies:
                        t = time.perf_counter()
                        client.ok("POST", "/s/_search", body)
                        lat[rate].append((time.perf_counter() - t) * 1e3)
        finally:
            telemetry.TRACER.configure(sample_rate=rate0)
        print(device, {r: round(statistics.median(v), 4)
                       for r, v in lat.items()})
    finally:
        server.stop()


if __name__ == "__main__":
    micro()
    import torch
    for dev in ("cpu", "cuda") if torch.cuda.is_available() else ("cpu",):
        http(dev)
