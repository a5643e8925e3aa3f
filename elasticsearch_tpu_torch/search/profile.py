"""Search profiler: per-shard timing breakdowns for `"profile": true` (port
of `elasticsearch_tpu/search/profile.py`).

The reference's `QueryProfiler` wraps each Lucene query with a breakdown
of timed stages; this engine runs a query as one vectorized pass, so the
breakdown reports that pass's phases (the per-doc advance / score split
collapses into `score`). `shard_profile` is one index's entry of
`profile.shards`, `hybrid_profile` the fused hybrid path's
`profile.hybrid`, and `trace_profile` the `profile.trace` the REST layer
adds. The reference's `profile.mesh` and `profile.fanout` wait for the
mesh and the cross-node fan-out, which are not ported.
"""

from __future__ import annotations

from typing import Optional


def _describe_query(body: dict) -> tuple:
    q = (body or {}).get("query", {"match_all": {}})
    if not isinstance(q, dict) or not q:
        return "MatchAllDocsQuery", "*:*"
    kind = next(iter(q))
    import json
    return kind, json.dumps(q.get(kind), default=str)[:200]


def hybrid_profile(index_name: str, plan_nanos: int, score_nanos: int,
                   fuse_nanos: int, hydrate_nanos: int, plan_cache_hit: bool,
                   batch_size: int, legs: list,
                   dispatch_events: Optional[list] = None,
                   queue_wait_nanos: Optional[int] = None,
                   device_dispatch_nanos: Optional[int] = None,
                   device_sync_nanos: Optional[int] = None,
                   scheduler: Optional[dict] = None) -> dict:
    """`profile` section for a fused hybrid (rank.rrf) search
    (search/hybrid_plan.py): the four plan phases — plan (parse/compile or
    cache hit), score (the batched leg dispatches), fuse (vectorized RRF),
    hydrate (fetch of the final window) — plus per-leg engine detail.

    score/fuse/hydrate are BATCH times: whole hybrid queries coalesce
    through the serving batcher, so the device work the timing describes
    was shared by `batch_size` queries (the per-query marginal cost is
    time/batch_size; reporting the honest batch figure keeps the profile
    additive with wall clock).

    Tail attribution (the closed-loop p99 split): `queue_wait_nanos` is
    how long the batch's longest-waiting member sat in the admission
    queue before being scheduled; `device_dispatch_nanos` /
    `device_sync_nanos` split score time into the launch share (the
    locked dispatch stage) and the deferred device wait at finalize —
    so a red p99/p50 gate is diagnosable as queueing vs device-launch
    vs device-wait vs hydrate directly from the profile. `scheduler`
    carries the continuous batcher's cumulative counters (topups,
    deadline_sheds, overlap_hits).

    dispatch_events: the launch event trace of this batch's score phase
    (`ops/dispatch.py` record_events): each hand kernel launched, its
    reference program, shape and variant."""
    breakdown = {"plan_nanos": plan_nanos,
                 "score_nanos": score_nanos,
                 "fuse_nanos": fuse_nanos,
                 "hydrate_nanos": hydrate_nanos}
    if queue_wait_nanos is not None:
        breakdown["queue_wait_nanos"] = queue_wait_nanos
    if device_dispatch_nanos is not None:
        breakdown["device_dispatch_nanos"] = device_dispatch_nanos
    if device_sync_nanos is not None:
        breakdown["device_sync_nanos"] = device_sync_nanos
    out = {"hybrid": {
        "id": f"[{index_name}][0]",
        "plan_cache": "hit" if plan_cache_hit else "miss",
        "batch_size": batch_size,
        "breakdown": breakdown,
        "legs": legs}}
    if scheduler is not None:
        out["hybrid"]["scheduler"] = scheduler
    if dispatch_events is not None:
        out["hybrid"]["dispatch"] = dispatch_events
    return out


def shard_profile(index_name: str, body: dict, query_nanos: int,
                  fetch_nanos: int, total_hits: int,
                  knn_phases: Optional[dict] = None,
                  dispatch_events: Optional[list] = None,
                  aggs_profile: Optional[dict] = None,
                  cache: Optional[dict] = None) -> dict:
    kind, description = _describe_query(body)
    breakdown = {
        "score": query_nanos * 7 // 10,
        "build_scorer": query_nanos * 2 // 10,
        "create_weight": query_nanos * 1 // 10,
        "next_doc": 0, "advance": 0, "match": 0,
        "compute_max_score": 0, "set_min_competitive_score": 0,
        "score_count": total_hits, "next_doc_count": 0, "advance_count": 0,
        "build_scorer_count": 1, "create_weight_count": 1, "match_count": 0,
        "compute_max_score_count": 0, "set_min_competitive_score_count": 0,
        "shallow_advance": 0, "shallow_advance_count": 0,
    }
    profile = {
        "id": f"[{index_name}][0]",
        "searches": [{
            "query": [{
                "type": kind,
                "description": description,
                "time_in_nanos": query_nanos,
                "breakdown": breakdown,
            }],
            "rewrite_time": 0,
            "collector": [{
                "name": "SimpleTopScoreDocCollector",
                "reason": "search_top_hits",
                "time_in_nanos": query_nanos,
            }],
        }],
        "fetch": {
            "type": "fetch",
            "description": "",
            "time_in_nanos": fetch_nanos,
            "breakdown": {"load_stored_fields": fetch_nanos,
                          "load_stored_fields_count": total_hits,
                          "next_reader": 0, "next_reader_count": 0},
        },
        "aggregations": [],
    }
    if knn_phases:
        # per-phase kNN engine breakdown (tpu_ivf: route = centroid
        # matmul + probe selection, score = pruned partition matmuls +
        # device top-k, merge = row-map join / result shaping; exhaustive
        # fallbacks report engine + reason only)
        profile["knn"] = {
            "engine": knn_phases.get("engine"),
            **{key: knn_phases[key]
               for key in ("nprobe", "nlist", "scored_rows",
                           "fallback_reason",
                           # generational-corpus annotations
                           # (segments/): how many device generations
                           # this search fanned over and what it masked
                           "generations", "l0_generations",
                           "tombstoned_rows", "legs",
                           # columnar segment-block-store ledger: the
                           # field's last refresh composition (cached /
                           # delta / full extraction counts)
                           "columnar",
                           # quant-subsystem legs: did the IVF probes
                           # run the fused gather+score kernel, and the
                           # two-phase exact-rescore window (size /
                           # promotions / nanos)
                           "fused_probe", "rescore")
               if key in knn_phases},
            "breakdown": {
                key: knn_phases[key]
                for key in ("route_nanos", "score_nanos", "merge_nanos")
                if key in knn_phases},
        }
    if dispatch_events:
        # the hand kernels this shard's query phase launched (see
        # ops/dispatch.py): reference program, shape, variant. The trace
        # is thread-local: a query coalesced into ANOTHER request's batch
        # reports its launches in that batch's runner's trace, so a
        # profiled search under concurrency may show an empty list even
        # though kernels ran (`ops/dispatch.LAUNCHES` is the counter that
        # sees every launch). Events a profiled runner launched for a
        # coalesced batch carry `coalesced_batch: N` (serving/batcher.py
        # annotates them), so it does not claim the batch's work as its
        # own.
        profile["dispatch"] = dispatch_events
    if (body or {}).get("aggs") or (body or {}).get("aggregations"):
        aggs = body.get("aggs") or body.get("aggregations")
        # the device-agg engine (search/agg_plan.py) reports which nodes
        # reduced on device vs fell through to the host walkers; `collect`
        # carries the device time, `build_aggregation` the host assembly
        # time (both whole-request figures attributed to each device node:
        # the engine times the fused pass, not per node)
        engines = {n["name"]: n
                   for n in (aggs_profile or {}).get("nodes", [])}
        entries = []
        for name, spec in aggs.items():
            info = engines.get(name, {})
            on_device = str(info.get("engine", "")).startswith("device")
            device_ns = (aggs_profile or {}).get("device_nanos", 0) \
                if on_device else 0
            assemble_ns = (aggs_profile or {}).get("assemble_nanos", 0) \
                if on_device else 0
            entry = {
                "type": next(iter(spec.keys()
                                  - {"aggs", "aggregations", "meta"}),
                             "unknown"),
                "description": name,
                "time_in_nanos": device_ns + assemble_ns,
                "breakdown": {"collect": device_ns,
                              "collect_count": total_hits,
                              "build_aggregation": assemble_ns,
                              "build_aggregation_count": 1,
                              "initialize": 0, "initialize_count": 1,
                              "reduce": 0, "reduce_count": 0}}
            if info:
                entry["engine"] = info["engine"]
                if "fallback_reason" in info:
                    entry["fallback_reason"] = info["fallback_reason"]
            entries.append(entry)
        profile["aggregations"] = entries
        if (aggs_profile or {}).get("columnar"):
            # the block-store composition of each agg column the request
            # read (blocks, cached vs extracted, mode)
            profile["columnar"] = aggs_profile["columnar"]
    if cache is not None:
        # shard request-cache state of THIS execution: which rung the
        # body was eligible for and whether the query phase was served
        # from it (a hit's query_nanos covers only the fetch re-run)
        profile["cache"] = cache
    return profile


def trace_profile(trace) -> dict:
    """`profile.trace` section: the request's telemetry trace id plus its
    longest spans so far, the bridge from the opt-in per-request profile
    to the always-on trace ring (`GET _nodes/traces` serves the full span
    tree under this id)."""
    return {"trace_id": trace.trace_id, "top_spans": trace.top_spans(5)}
