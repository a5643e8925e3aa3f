"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed 1234] [--n-sift 1000000] [--n-cohere 1000000]
                          [--n-gist 1000000] [--n-cohere-ivf 1000000]

Phases, one line each; any failure raises and the exit code is not 0:

  env          the card (name, power limit), torch and nvcc versions
  build        compiles the hand-written kernels from `elasticsearch_tpu_torch/csrc`
               (one nvcc per source, all started together)
  kernels      each binned kernel against its plain PyTorch version on the card
               (bf16 Q=256 N=1,048,576 D=128, cosine and clamped; int8 Q=256
               N=1,048,576 D=768), then CUDA-event times beside the bound and
               beside one PyTorch matmul of the same product; then each fused
               IVF probe kernel against its plain version (nlist 1024, cap
               1472, nprobe 32, Q=256 and Q=1; bf16 D=960, int8 D=768, int4
               D=768, and D=100 rows on the scalar path), timed beside the
               bound of its distinct tiles and beside the port's scan route
  serve_sift   the port's REST server in-process: a cosine dims=128 index,
               2,000 docs over `_bulk`, then the shard loaded to 1,000,000
               SIFT-shaped docs through `Engine.index_many`, refresh, and 64
               `_search {knn, k: 10}` requests over HTTP: recall@10 against
               exact f32 numpy and the bf16 kernel's launch count; then a
               dot_product index (16,384 docs) through the clamped variant
  serve_cohere the same for a 768-d cosine `int8_flat` index with
               `rescore: true` and `_source` disabled (int8 kernel + re-rank)
  serve_gist   a 1,000,000 x 960 dot_product `ivf` index of unit-normalized
               clustered rows (the fused bf16 kernel, one launch a request,
               recall@10 >= 0.95), then a 65,536 x 960 l2_norm `ivf` index
               (the scan route: no fused launch)
  serve_cohere_ivf  1,000,000 x 768 cosine rows (~64 docs per cluster, the
               reference's quantization-ladder shape) under `int8_ivf` (the fused
               kernel on int8 tiles: routing recall >= 0.95 against the same
               index at nprobe = nlist, recall@10 >= 0.90) and under
               `int4_ivf` (the int4 kernel + exact rescore, recall@10 >= 0.95)
Each IVF index answers one warm-up search first (the `nprobe: auto` tuner
runs there), then the timed requests; every request must take the fused
route with no exhaustive fallback.

The next-to-last lines are a JSON object with every kernel's numbers and the
card's `nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {...}}. It needs one CUDA card and exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import gc
import http.client
import json
import resource
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
BF16_QUANTUM = 2.0 ** -15       # one packing quantum at shifted scores in [4, 8)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases

def phase_env() -> str:
    from elasticsearch_tpu_torch.ops import _build
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log("env", gpu=repr(smi), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=repr(nvcc),
        count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from elasticsearch_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = _build.build(["knn_binned", "ivf_fused"])
    usage = [ln.strip() for rep in reports.values() for ln in rep.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=f"{time.perf_counter() - t0:.1f}",
        ptxas=repr(" | ".join(usage)))


def phase_kernels(seed: int, dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    g = torch.Generator(device=dev).manual_seed(seed)
    nq, n_pad = 256, 1 << 20
    num_valid = n_pad - 1000          # a padded tail that must never win
    valid, tpat = kb._tile_patterns(n_pad, num_valid, dev)
    out = {}

    def decoded(p):
        return (p & kb.MASK).view(torch.float32)

    # bf16: unit rows (cosine), and rows scaled so clamping is exercised
    d = 128
    q = torch.randn(nq, d, generator=g, device=dev)
    c = torch.randn(n_pad, d, generator=g, device=dev)
    q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    c = (c / c.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    fields = {}
    for variant, clamp, cc in (("cosine", False, c),
                               ("clamped", True, (c.float() * 8).to(torch.bfloat16))):
        got = kb.binned_packed_bf16(q, cc, valid, clamp=clamp)
        want = kb.binned_packed_reference(q, cc, valid, tpat, clamp=clamp)
        torch.cuda.synchronize()
        err = float((decoded(got) - decoded(want)).abs().max())
        same = float((got == want).float().mean())
        if not err <= BF16_QUANTUM:
            raise AssertionError(f"bf16 {variant}: max |decoded diff| {err} "
                                 f"exceeds one quantum {BF16_QUANTUM}")
        fields[f"{variant}_max_abs_err"] = err
        fields[f"{variant}_identical"] = f"{same:.6f}"
        fields[f"{variant}_ms"] = time_ms(
            lambda: kb.binned_packed_bf16(q, cc, valid, clamp=clamp))
    q1 = q[:1].contiguous()
    fields["cosine_q1_ms"] = time_ms(
        lambda: kb.binned_packed_bf16(q1, c, valid, clamp=False))
    plain_ms = time_ms(lambda: kb.binned_packed_reference(q, c, valid, tpat),
                       iters=5, warmup=1)
    lib_ms = time_ms(lambda: torch.matmul(q, c.T))
    nbytes = q.numel() * 2 + c.numel() * 2 + n_pad * 4 + nq * (n_pad // 64) * 4
    b_ms, b_by = bound_ms(nbytes, 2 * nq * n_pad * d, BF16_OPS_PER_S)
    out[kb.KERNEL_BF16] = {
        "name": kb.KERNEL_BF16, "route": "cuda",
        "source": "elasticsearch_tpu_torch/csrc/knn_binned.cu",
        "replaces": "elasticsearch_tpu/ops/pallas_knn_binned.py:76",
        "max_abs_err": max(fields["cosine_max_abs_err"],
                           fields["clamped_max_abs_err"]),
        "ms": fields["cosine_ms"], "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms}
    log("kernels", kernel=kb.KERNEL_BF16, Q=nq, N=n_pad, D=d,
        **{k: (f"{v:.6g}" if isinstance(v, float) else v)
           for k, v in fields.items()},
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
        matmul_ms=f"{lib_ms:.4f}")
    del q, c

    # int8 at the Cohere width
    d = 768
    q8 = torch.randint(-127, 128, (nq, d), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    c8 = torch.randint(-127, 128, (n_pad, d), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    qscale = (torch.rand(nq, 1, generator=g, device=dev) + 0.5) / 127.0 / 3.0
    # scales put the dequantized scores around [-3, 3], so the clip at
    # both ends and the padding's zero weight are all exercised
    rsv = ((torch.rand(1, n_pad, generator=g, device=dev) + 0.5)
           / 127.0 / 3.0) * valid
    got = kb.binned_packed_int8(q8, c8, qscale, rsv)
    want = kb.binned_packed_reference(q8, c8, rsv, tpat, qscale=qscale)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"int8 kernel differs from its plain version "
                             f"in {bad} packed values")
    err = float((decoded(got) - decoded(want)).abs().max())
    k_ms = time_ms(lambda: kb.binned_packed_int8(q8, c8, qscale, rsv))
    q1_ms = time_ms(lambda: kb.binned_packed_int8(
        q8[:1].contiguous(), c8, qscale[:1].contiguous(), rsv))
    plain_ms = time_ms(lambda: kb.binned_packed_reference(
        q8, c8, rsv, tpat, qscale=qscale), iters=5, warmup=1)
    lib_ms = time_ms(lambda: torch._int_mm(q8, c8.T))
    nbytes = (q8.numel() + c8.numel() + nq * 4 + n_pad * 4
              + nq * (n_pad // 64) * 4)
    b_ms, b_by = bound_ms(nbytes, 2 * nq * n_pad * d, INT8_OPS_PER_S)
    out[kb.KERNEL_INT8] = {
        "name": kb.KERNEL_INT8, "route": "cuda",
        "source": "elasticsearch_tpu_torch/csrc/knn_binned.cu",
        "replaces": "elasticsearch_tpu/ops/pallas_knn_binned.py:93",
        "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    log("kernels", kernel=kb.KERNEL_INT8, Q=nq, N=n_pad, D=d,
        bit_identical=True, ms=f"{k_ms:.4f}", q1_ms=f"{q1_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{b_ms:.4f}", bound_by=b_by,
        int_mm_ms=f"{lib_ms:.4f}")
    return out


def _ivf_partitions(g, dev, dtype, nlist: int, cap: int, d: int):
    """Random partition tiles at the main path's layout: about a third of
    each partition's tail slots empty (scale 0, row -1), as capacity slack
    leaves them."""
    from elasticsearch_tpu_torch.ops.knn_ivf import IVFPartitions
    w = d // 2 if dtype == torch.uint8 else d
    if dtype in (torch.int8, torch.uint8):
        lo, hi = (-127, 128) if dtype == torch.int8 else (0, 256)
        parts = torch.randint(lo, hi, (nlist, cap, w), generator=g,
                              device=dev, dtype=torch.int32).to(dtype)
    else:
        parts = torch.randn(nlist, cap, w, generator=g, device=dev,
                            dtype=dtype) / d ** 0.5
    quantized = dtype in (torch.int8, torch.uint8)
    scales = ((torch.rand(nlist, cap, generator=g, device=dev) + 0.5) / 127
              / d ** 0.5 if quantized else torch.ones(nlist, cap, device=dev))
    fill = torch.randint(2 * cap // 3, cap + 1, (nlist, 1), generator=g,
                         device=dev)
    valid = torch.arange(cap, device=dev)[None, :] < fill
    rows = torch.arange(nlist * cap, device=dev, dtype=torch.int32).view(
        nlist, cap)
    rows = torch.where(valid, rows, torch.full_like(rows, -1))
    centroids = torch.randn(nlist, d, generator=g, device=dev)
    return IVFPartitions(
        centroids=centroids, centroid_sq=(centroids ** 2).sum(1),
        parts=parts, part_scales=torch.where(valid, scales,
                                             torch.zeros_like(scales)),
        part_sq=torch.zeros(nlist, cap, device=dev), part_rows=rows)


def _ivf_case(g, dev, dtype, d, nlist=1024, cap=1472, nprobe=32,
              queries=(256, 1), timed=True):
    """One tile type at one width: the kernel against its plain version at
    each query count (NEG_INF slots identical, the rest within 1e-5 of the
    largest |score|), then, when `timed`, CUDA-event times beside the
    plain version, the scan route and the bound of the distinct tiles."""
    from elasticsearch_tpu_torch.ops import ivf_fused as fused
    from elasticsearch_tpu_torch.ops import knn_ivf
    ivf = _ivf_partitions(g, dev, dtype, nlist, cap, d)
    out = {"max_abs_err": 0.0}
    for nq in queries:
        q = torch.randn(nq, d, generator=g, device=dev)
        q = q / q.norm(dim=1, keepdim=True)
        ids = torch.randint(0, nlist, (nq, nprobe), generator=g, device=dev,
                            dtype=torch.int32)
        got = fused.probe_board(q, ivf, ids)
        want = fused.probe_board_reference(q, ivf, ids)
        torch.cuda.synchronize()
        neg = want <= -1e37
        if not torch.equal(got <= -1e37, neg) or \
                not bool((got[neg] == want[neg]).all()):
            raise AssertionError(f"ivf {dtype} D={d} Q={nq}: NEG_INF slots "
                                 f"differ from the plain version")
        err = float((got[~neg] - want[~neg]).abs().max())
        tol = 1e-5 * max(1.0, float(want[~neg].abs().max()))
        if not err <= tol:
            raise AssertionError(f"ivf {dtype} D={d} Q={nq}: max |diff| "
                                 f"{err} exceeds {tol}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        del got, want, neg
        if not timed:
            continue
        out[f"q{nq}_ms"] = time_ms(lambda: fused.probe_board(q, ivf, ids))
        if nq == queries[0]:
            out["plain_ms"] = time_ms(
                lambda: fused.probe_board_reference(q, ivf, ids),
                iters=3, warmup=1)
            out["scan_ms"] = time_ms(
                lambda: knn_ivf.score_probes(q, ivf, ids, 10), iters=3,
                warmup=1)
            tiles = int(torch.unique(ids).numel())
            tile_bytes = cap * ivf.parts.shape[2] * ivf.parts.element_size()
            nbytes = (tiles * (tile_bytes + cap * 4) + q.numel() * 4
                      + ids.numel() * 4 + nq * nprobe * cap * 4)
            out["bound_ms"], out["bound_by"] = bound_ms(
                nbytes, 2 * nq * nprobe * cap * d, BF16_OPS_PER_S)
            out["distinct_tiles"] = tiles
    del ivf
    torch.cuda.empty_cache()
    return out


def phase_ivf_kernels(seed: int, dev) -> dict:
    """Both fused IVF probe kernels against their plain versions at the
    main path's layout (1M rows at slack 1.5: nlist 1024, cap 1472)."""
    from elasticsearch_tpu_torch.ops import ivf_fused as fused
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    cases = {}
    for label, dtype, d in (("bf16_960", torch.bfloat16, 960),
                            ("int8_768", torch.int8, 768),
                            ("int4_768", torch.uint8, 768)):
        cases[label] = _ivf_case(g, dev, dtype, d)
        log("kernels", kernel=(fused.KERNEL_INT4 if dtype == torch.uint8
                               else fused.KERNEL_DENSE), case=label,
            nlist=1024, cap=1472, nprobe=32,
            **{k: (f"{v:.6g}" if isinstance(v, float) else v)
               for k, v in cases[label].items()},
            library="scan route (knn_ivf.score_probes: per-slot gather + "
                    "einsum + top-k merge; no single PyTorch call fuses "
                    "gather and score)")
    # rows whose bytes are not a multiple of 16 take the scalar path
    for label, dtype in (("f32_100", torch.float32),
                         ("bf16_100", torch.bfloat16),
                         ("int8_100", torch.int8),
                         ("int4_100", torch.uint8)):
        cases[label] = _ivf_case(g, dev, dtype, 100, nlist=64, cap=200,
                                 nprobe=8, queries=(37, 1), timed=False)
        log("kernels", case=label, max_abs_err=cases[label]["max_abs_err"])
    out = {}
    for name, main, extra in (
            (fused.KERNEL_DENSE, "bf16_960", ("int8_768", "f32_100",
                                              "bf16_100", "int8_100")),
            (fused.KERNEL_INT4, "int4_768", ("int4_100",))):
        c = cases[main]
        out[name] = {
            "name": name, "route": "cuda",
            "source": "elasticsearch_tpu_torch/csrc/ivf_fused.cu",
            "replaces": ("elasticsearch_tpu/ops/pallas_ivf_fused.py:84"
                         if name == fused.KERNEL_DENSE else
                         "elasticsearch_tpu/ops/pallas_ivf_fused.py:98"),
            "max_abs_err": max(cases[x]["max_abs_err"]
                               for x in (main, *extra)),
            "ms": c["q256_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["scan_ms"]}
    return out


class Client:
    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def req(self, method, path, body=None, ndjson=False):
        if body is None:
            raw = b""
        elif ndjson:
            raw = b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
        else:
            raw = json.dumps(body).encode()
        self.conn.request(method, path, body=raw,
                          headers={"content-type": "application/json"})
        resp = self.conn.getresponse()
        data = resp.read()
        return resp.status, (json.loads(data) if data else None)

    def ok(self, method, path, body=None, ndjson=False):
        status, payload = self.req(method, path, body, ndjson)
        if status >= 300:
            raise AssertionError(f"{method} {path} -> {status}: {payload}")
        return payload


def clustered(rng, n: int, d: int):
    """SIFT-shaped clustered vectors (as `bench.py` makes them)."""
    centers = rng.standard_normal((256, d)).astype(np.float32) * 2.0
    assign = rng.integers(0, 256, size=n)
    return centers[assign] + rng.standard_normal((n, d)).astype(np.float32)


def exact_top(vectors: np.ndarray, queries: np.ndarray, k: int,
              metric: str) -> np.ndarray:
    """Exact f32 top-k rows in numpy, in row chunks."""
    q = queries
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    best = None
    for lo in range(0, len(vectors), 1 << 18):
        block = vectors[lo:lo + (1 << 18)]
        if metric == "cosine":
            block = block / np.linalg.norm(block, axis=1, keepdims=True)
        s = q @ block.T
        if metric == "l2_norm":
            # -||q - v||² up to the per-query constant ||q||²
            s = 2.0 * s - np.einsum("nd,nd->n", block, block)[None, :]
        top = np.argpartition(-s, k, axis=1)[:, :k]
        cand = (np.take_along_axis(s, top, 1), top + lo)
        if best is None:
            best = cand
        else:
            s2 = np.concatenate([best[0], cand[0]], 1)
            i2 = np.concatenate([best[1], cand[1]], 1)
            sel = np.argsort(-s2, axis=1)[:, :k]
            best = (np.take_along_axis(s2, sel, 1), np.take_along_axis(i2, sel, 1))
    return best[1]


class IvfBuildTimer:
    """Seconds spent in IVF k-means training, in row placement (both at
    refresh) and in the upload of the partitions to the card (host
    encoding included; at the first search), by wrapping the functions
    that do them."""

    KEYS = ("train", "place", "upload")

    def __init__(self):
        from elasticsearch_tpu_torch.ann import ivf_index
        self.reset()
        self._mod, self._cls = ivf_index.kmeans_lib, ivf_index.IVFIndex
        self._orig = (self._mod.train_kmeans, self._cls._place_chunked,
                      self._cls.device_partitions)

        def timed(key, fn):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.seconds[key] += time.perf_counter() - t
            return run

        self._mod.train_kmeans = timed("train", self._orig[0])
        self._cls._place_chunked = timed("place", self._orig[1])
        self._cls.device_partitions = timed("upload", self._orig[2])

    def reset(self):
        self.seconds = dict.fromkeys(self.KEYS, 0.0)

    def close(self):
        (self._mod.train_kmeans, self._cls._place_chunked,
         self._cls.device_partitions) = self._orig


def serve_index(client, node, name, mapping, vectors, queries, metric,
                kernel, k=10, first=2000, settings=None, warmup=False):
    """Create, bulk-load `first` docs over HTTP and check one search, load
    the rest through `Engine.index_many`, refresh, optionally answer one
    warm-up search, then answer every query over HTTP, then once more
    straight through the store (no HTTP, no JSON) after the launch counts
    were read. `kernel` is the one kernel each request must launch once,
    or None for a route that launches none. Returns (recall@k, HTTP p50
    ms, store p50 ms, ingest s, launches, hits of the HTTP requests)."""
    from elasticsearch_tpu_torch.ops import dispatch
    client.ok("PUT", f"/{name}", {
        "settings": dict(settings or {}, number_of_shards=1),
        "mappings": mapping})
    n, field = len(vectors), "vec"
    ops = []
    for i in range(min(first, n)):
        ops += [{"index": {"_id": str(i)}}, {field: vectors[i].tolist()}]
    resp = client.ok("POST", f"/{name}/_bulk", ops, ndjson=True)
    if resp["errors"]:
        raise AssertionError(f"bulk errors: {resp['items'][:3]}")
    client.ok("POST", f"/{name}/_refresh")
    small_q = vectors[7] + 0.01
    hits = client.ok("POST", f"/{name}/_search", {"knn": {
        "field": field, "query_vector": small_q.tolist(), "k": k,
        "num_candidates": 100}})["hits"]["hits"]
    want = exact_top(vectors[:first], small_q[None, :], k, metric)[0]
    got = [int(h["_id"]) for h in hits]
    # the query sits next to doc 7: it must rank first, and the rest must
    # mostly agree with exact f32 (cluster mates lie close together)
    if got[0] != 7 or len(set(got) & set(want.tolist())) < k // 2:
        raise AssertionError(f"small-index search: got {got}, want {want}")

    t0 = time.perf_counter()
    if n > first:
        node.index(name).engine.index_many(
            [str(i) for i in range(first, n)], vectors={field: vectors[first:]})
    client.ok("POST", f"/{name}/_refresh")
    ingest_s = time.perf_counter() - t0
    if warmup:
        t0 = time.perf_counter()
        client.ok("POST", f"/{name}/_search", {"knn": {
            "field": field, "query_vector": queries[0].tolist(), "k": k,
            "num_candidates": 100}})
        log("warmup", index=name, seconds=f"{time.perf_counter() - t0:.3f}")

    store = node.index(name).store
    dispatch.reset_launches()
    stats0 = dict(store.knn_stats)
    lat, got = [], []
    for qv in queries:
        body = {"knn": {"field": field, "query_vector": qv.tolist(), "k": k,
                        "num_candidates": 100}, "size": k}
        t = time.perf_counter()
        resp = client.ok("POST", f"/{name}/_search", body)
        lat.append((time.perf_counter() - t) * 1e3)
        got.append([int(h["_id"]) for h in resp["hits"]["hits"]])
        if not all(np.isfinite(h["_score"]) for h in resp["hits"]["hits"]) \
                or len(got[-1]) != k:
            raise AssertionError(f"bad hits: {resp['hits']}")
    launches = dispatch.launches()
    stats = {key: v - stats0[key] for key, v in store.knn_stats.items()}
    store_lat = []
    for qv in queries:
        t = time.perf_counter()
        store.search(field, qv, k)        # lands results on the host
        store_lat.append((time.perf_counter() - t) * 1e3)
    want = {} if kernel is None else {kernel: len(queries)}
    if {n: c for n, c in launches.items() if c} != want:
        raise AssertionError(f"launches {launches} for {len(queries)} "
                             f"requests; expected {want}")
    truth = exact_top(vectors, queries, k, metric)
    recall = float(np.mean([len(set(g) & set(t.tolist())) / k
                            for g, t in zip(got, truth)]))
    return (recall, statistics.median(lat), statistics.median(store_lat),
            ingest_s, launches, {"hits": got, "stats": stats})


def phase_serve(seed: int, n_sift: int, n_cohere: int,
                device: str = "cuda") -> dict:
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    from elasticsearch_tpu_torch.server import build_server
    node, server = build_server(device=device, port=0)
    server.start()
    total = {kb.KERNEL_BF16: 0, kb.KERNEL_INT8: 0}
    try:
        client = Client(server.port)
        rng = np.random.default_rng(seed)

        vecs = clustered(rng, n_sift, 128)
        queries = vecs[rng.integers(0, n_sift, 64)] \
            + 0.3 * rng.standard_normal((64, 128)).astype(np.float32)
        recall, p50, store_p50, ingest, launches, _ = serve_index(
            client, node, "sift",
            {"properties": {"vec": {"type": "dense_vector", "dims": 128,
                                    "similarity": "cosine"}}},
            vecs, queries, "cosine", kb.KERNEL_BF16)
        total[kb.KERNEL_BF16] += launches.get(kb.KERNEL_BF16, 0)
        if recall < 0.95:
            raise AssertionError(f"serve_sift recall@10 {recall} < 0.95")
        log("serve_sift", docs=n_sift, dims=128, requests=len(queries),
            ingest_s=f"{ingest:.2f}", p50_ms=f"{p50:.3f}",
            store_p50_ms=f"{store_p50:.3f}",
            recall_at_10=recall, launches=json.dumps(launches))
        del vecs

        # dot_product through the clamped variant of the bf16 kernel
        dvecs = clustered(rng, 16384, 128)
        dvecs /= np.linalg.norm(dvecs, axis=1, keepdims=True)
        dq = dvecs[rng.integers(0, 16384, 16)] \
            + 0.03 * rng.standard_normal((16, 128)).astype(np.float32)
        recall, p50, store_p50, _, launches, _ = serve_index(
            client, node, "dot",
            {"properties": {"vec": {"type": "dense_vector", "dims": 128,
                                    "similarity": "dot_product"}}},
            dvecs, dq, "dot_product", kb.KERNEL_BF16)
        total[kb.KERNEL_BF16] += launches.get(kb.KERNEL_BF16, 0)
        if recall < 0.95:
            raise AssertionError(f"dot_product recall@10 {recall} < 0.95")
        log("serve_sift", index="dot", docs=16384, requests=len(dq),
            p50_ms=f"{p50:.3f}",
            store_p50_ms=f"{store_p50:.3f}", recall_at_10=recall,
            launches=json.dumps(launches))

        cvecs = clustered(rng, n_cohere, 768)
        cq = cvecs[rng.integers(0, n_cohere, 64)] \
            + 0.3 * rng.standard_normal((64, 768)).astype(np.float32)
        recall, p50, store_p50, ingest, launches, _ = serve_index(
            client, node, "cohere",
            {"_source": {"enabled": False},
             "properties": {"vec": {
                 "type": "dense_vector", "dims": 768, "similarity": "cosine",
                 "index_options": {"type": "int8_flat", "rescore": True}}}},
            cvecs, cq, "cosine", kb.KERNEL_INT8)
        total[kb.KERNEL_INT8] += launches.get(kb.KERNEL_INT8, 0)
        if recall < 0.95:
            raise AssertionError(f"serve_cohere recall@10 {recall} < 0.95")
        log("serve_cohere", docs=n_cohere, dims=768, requests=len(cq),
            ingest_s=f"{ingest:.2f}", p50_ms=f"{p50:.3f}",
            store_p50_ms=f"{store_p50:.3f}",
            recall_at_10=recall, launches=json.dumps(launches))
    finally:
        server.stop()
    return total


def clustered32(rng, n: int, d: int, n_centers: int = 256,
                chunk: int = 1 << 17):
    """`clustered` rows made in float32 chunks, with no float64 temp of
    the whole matrix."""
    centers = rng.standard_normal((n_centers, d), dtype=np.float32) * 2.0
    assign = rng.integers(0, n_centers, size=n)
    out = np.empty((n, d), dtype=np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out[lo:hi] = centers[assign[lo:hi]] + rng.standard_normal(
            (hi - lo, d), dtype=np.float32)
    return out


def unit(x: np.ndarray) -> np.ndarray:
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def serve_ivf(client, node, timer, name, field, vectors, queries, metric,
              kernel, settings=None):
    """One IVF index through `serve_index` (500 docs over `_bulk` first, so
    the small shard stays exhaustive and the full refresh trains once),
    then the IVF checks: every timed request took the IVF route (the fused
    route when `kernel` is set) with no fallback. Returns (recall, the
    store's field, the HTTP hits, the fields to log)."""
    timer.reset()
    on_card = node.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mapping = {"_source": {"enabled": False},
               "properties": {"vec": field}}
    recall, p50, store_p50, ingest, launches, extra = serve_index(
        client, node, name, mapping, vectors, queries, metric, kernel,
        first=500, settings=settings, warmup=True)
    stats, n = extra["stats"], len(queries)
    fc = node.index(name).store.field("vec")
    want = {"ivf_searches": n, "fallback_searches": 0,
            "fused_probe_searches": n if kernel else 0}
    if {key: stats[key] for key in want} != want or fc.router is None:
        raise AssertionError(f"{name}: knn_stats over the timed requests "
                             f"{stats}, expected {want}")
    phases = node.index(name).store.last_knn_phases
    fields = dict(docs=len(vectors), dims=vectors.shape[1],
                  requests=n, nlist=fc.router.index.nlist,
                  cap=fc.router.index.cap, nprobe=phases["nprobe"],
                  scored_rows=phases["scored_rows"],
                  fused=phases["fused_probe"],
                  ingest_s=f"{ingest:.2f}",
                  ivf_train_s=f"{timer.seconds['train']:.2f}",
                  ivf_place_s=f"{timer.seconds['place']:.2f}",
                  ivf_upload_s=f"{timer.seconds['upload']:.2f}",
                  p50_ms=f"{p50:.3f}", store_p50_ms=f"{store_p50:.3f}",
                  recall_at_10=recall, launches=json.dumps(launches))
    # the router's phase times (after a device sync each), mean per request
    for phase in ("route", "score", "merge", "rescore"):
        fields[f"{phase}_ms"] = f"{stats[phase + '_nanos'] / n / 1e6:.4f}"
    # peak memory: the card's over this index, the host process's so far
    # (ru_maxrss is in KiB on Linux)
    if on_card:
        fields["device_peak_gb"] = f"{torch.cuda.max_memory_allocated() / 1e9:.2f}"
    fields["host_peak_rss_gb"] = \
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9:.2f}"
    return recall, fc, extra["hits"], fields, launches


def drop_index(node, name: str) -> None:
    node.indices.pop(name)
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_ivf(seed: int, n_gist: int, n_cohere: int,
                    device: str = "cuda") -> dict:
    """serve_gist and serve_cohere_ivf: the tpu_ivf engine over HTTP."""
    from elasticsearch_tpu_torch.ops import ivf_fused as fused
    from elasticsearch_tpu_torch.server import build_server
    node, server = build_server(device=device, port=0)
    server.start()
    timer = IvfBuildTimer()
    total = {fused.KERNEL_DENSE: 0, fused.KERNEL_INT4: 0}
    try:
        client = Client(server.port)
        rng = np.random.default_rng(seed + 2)

        # GIST-shaped (960-d), dot_product over unit rows: BASELINE config 2
        raw = clustered32(rng, n_gist, 960)
        pick = rng.integers(0, n_gist, 64)
        queries = unit(raw[pick] + 0.3 * rng.standard_normal(
            (64, 960), dtype=np.float32))
        vecs = unit(raw)
        del raw
        recall, _, _, fields, launches = serve_ivf(
            client, node, timer, "gist", {
                "type": "dense_vector", "dims": 960,
                "similarity": "dot_product",
                "index_options": {"type": "ivf"}},
            vecs, queries, "dot_product", fused.KERNEL_DENSE)
        total[fused.KERNEL_DENSE] += launches.get(fused.KERNEL_DENSE, 0)
        log("serve_gist", index="ivf", **fields)
        if recall < 0.95:
            raise AssertionError(f"serve_gist recall@10 {recall} < 0.95")
        drop_index(node, "gist")

        # l2_norm takes the scan route: no fused launch
        n_l2 = min(65536, n_gist)
        l2q = vecs[rng.integers(0, n_l2, 16)] + 0.01 * rng.standard_normal(
            (16, 960), dtype=np.float32)
        recall, _, _, fields, _ = serve_ivf(
            client, node, timer, "gist_l2", {
                "type": "dense_vector", "dims": 960,
                "similarity": "l2_norm", "index_options": {"type": "ivf"}},
            np.ascontiguousarray(vecs[:n_l2]), l2q, "l2_norm", None)
        log("serve_gist", index="ivf_l2", **fields)
        if recall < 0.95:
            raise AssertionError(f"serve_gist l2 recall@10 {recall} < 0.95")
        drop_index(node, "gist_l2")
        del vecs

        # Cohere-shaped (768-d) cosine: BASELINE config 4, int8 and int4.
        # The reference's quantization-ladder bench shape (`bench_matrix.py`
        # config 12): ~64 docs per cluster, so a query's true top-10 are
        # same-cluster rows with real score gaps. With 256 isotropic blobs
        # of ~3,900 docs, neighbours 2-10 differ by less than int4's
        # rounding noise, and no coarse window of 40 holds them (PERF.md,
        # PR 2).
        cvecs = clustered32(rng, n_cohere, 768,
                            n_centers=max(n_cohere // 64, 1))
        cq = cvecs[rng.integers(0, n_cohere, 64)] + 0.3 * rng.standard_normal(
            (64, 768), dtype=np.float32)
        for otype, kernel, gate in (("int8_ivf", fused.KERNEL_DENSE, 0.90),
                                    ("int4_ivf", fused.KERNEL_INT4, 0.95)):
            name = f"cohere_{otype}"
            recall, fc, hits, fields, launches = serve_ivf(
                client, node, timer, name, {
                    "type": "dense_vector", "dims": 768,
                    "similarity": "cosine",
                    "index_options": {"type": otype}},
                cvecs, cq, "cosine", kernel)
            total[kernel] += launches.get(kernel, 0)
            if otype == "int8_ivf":
                # routing recall: the tuned probing against the same index
                # probed in full (the reference's own int8 gate)
                _, rows, _ = fc.router.search(cq, 10,
                                              nprobe=fc.router.index.nlist)
                full = [set(fc.row_map[r[r >= 0]].tolist()) for r in rows]
                routing = float(np.mean([len(set(h) & f) / 10
                                         for h, f in zip(hits, full)]))
                fields["routing_recall_at_10"] = routing
                if routing < 0.95:
                    raise AssertionError(f"{name} routing recall {routing} "
                                         f"< 0.95")
            log("serve_cohere_ivf", index=otype, **fields)
            if recall < gate:
                raise AssertionError(f"{name} recall@10 {recall} < {gate}")
            drop_index(node, name)
    finally:
        timer.close()
        server.stop()
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--n-sift", type=int, default=1_000_000)
    ap.add_argument("--n-cohere", type=int, default=1_000_000)
    ap.add_argument("--n-gist", type=int, default=1_000_000)
    ap.add_argument("--n-cohere-ivf", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import elasticsearch_tpu_torch  # noqa: F401  (fails outside the repo)

    smi = phase_env()
    phase_build()
    kernels = phase_kernels(args.seed, torch.device("cuda"))
    kernels.update(phase_ivf_kernels(args.seed, torch.device("cuda")))
    launches = phase_serve(args.seed, args.n_sift, args.n_cohere)
    launches.update(phase_serve_ivf(args.seed, args.n_gist,
                                    args.n_cohere_ivf))
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
