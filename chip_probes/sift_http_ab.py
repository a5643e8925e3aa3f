"""Serve sift (1M x 128 cosine `flat`, `chip_smoke.py`'s data from seed
1234) over HTTP from one checkout and time it: 256 sequential requests,
then 512 requests at C = 1 and at C = 8 (`chip_smoke.run_clients`), with
the index batcher's batches and dispatch ms a batch. For comparing a
parent commit with a change on one card: unpack the parent into a
directory, and run from each tree in turns (parent, change, change,
parent) in one run on the card:

    python3 chip_probes/sift_http_ab.py <tree> <label>

The label `stub` runs the tree with its request-path telemetry replaced
by no-ops (`telemetry.rest_request`, the batcher's thread sections, the
metric records, the thread context and spans, the store's in-flight
count), to see what the telemetry itself costs. Prints one `AB` line of
JSON. Needs a CUDA card.
"""
import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np


def stub_telemetry() -> None:
    from elasticsearch_tpu_torch import telemetry
    from elasticsearch_tpu_torch.serving import batcher
    from elasticsearch_tpu_torch.telemetry import metrics, trace
    from elasticsearch_tpu_torch.vectors import store

    @contextlib.contextmanager
    def nothing(*_a, **_k):
        yield None

    telemetry.rest_request = nothing
    batcher._section = nothing
    metrics.record = lambda *a, **k: None
    trace.capture = lambda: (None, None, None)
    trace.record_span = lambda *a, **k: None
    store.VectorStoreShard._begin_dispatch = lambda self: 0
    store.VectorStoreShard._end_dispatch = lambda self: None


def main(tree: str, label: str) -> None:
    sys.path.insert(0, tree)
    os.chdir(tree)
    import chip_smoke as cs
    if label == "stub":
        stub_telemetry()
    from elasticsearch_tpu_torch.server import build_server
    cs.phase_build(["knn_binned"])
    node, server = build_server(device="cuda", port=0,
                                settings=cs.SERVE_SETTINGS)
    server.start()
    try:
        client = cs.Client(server.port)
        rng = np.random.default_rng(1234)
        vecs = cs.clustered(rng, 1_000_000, 128)
        queries = vecs[rng.integers(0, len(vecs), 64)] \
            + 0.3 * rng.standard_normal((64, 128)).astype(np.float32)
        client.ok("PUT", "/sift", {"mappings": {"properties": {"vec": {
            "type": "dense_vector", "dims": 128, "similarity": "cosine"}}}})
        node.index("sift").index_many([str(i) for i in range(len(vecs))],
                                      vectors={"vec": vecs})
        client.ok("POST", "/sift/_refresh")
        bodies = [cs.knn_body("vec", q) for q in queries]
        seq = []
        for body in bodies * 4:
            t = time.perf_counter()
            client.ok("POST", "/sift/_search", body)
            seq.append((time.perf_counter() - t) * 1e3)
        out = {"label": label,
               "seq_p50_ms": round(statistics.median(seq[64:]), 4)}
        stats = node.index("sift").vector_store.scheduler_stats
        for c in (1, 8):
            st0 = stats()
            qps, res = cs.run_clients(server.port, "/sift/_search", bodies,
                                      c, 512)
            st = stats()
            ms = [r[2] for r in res]
            nb = max(st["batches"] - st0["batches"], 1)
            out[f"C{c}"] = {
                "qps": round(qps, 1), "p50": round(statistics.median(ms), 3),
                "p99": round(float(np.percentile(ms, 99)), 3),
                "batch": round(512 / nb, 2),
                "dispatch_ms": round((st["dispatch_nanos"]
                                      - st0["dispatch_nanos"]) / nb / 1e6, 3)}
        print("AB", json.dumps(out))
    finally:
        server.stop()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
