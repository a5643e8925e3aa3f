"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed 1234] [--n-sift 1000000] [--n-cohere 1000000]
                          [--n-gist 500000] [--n-cohere-ivf 1000000]
                          [--n-colbert 131071] [--n-laion 1000000]
                          [--n-sharded 1000000] [--n-msmarco 262144]
                          [--n-sparse 262144] [--n-logs 100000]
                          [--n-qa 100000]
                          [--binned-only | --ivf-only | --maxsim-only |
                           --sharded-only | --hybrid-only | --sparse-only |
                           --docs-only | --segments-only | --body-only |
                           --logs-only | --telemetry-only | --dsl-only |
                           --search-api-only | --nested-only |
                           --node-apis-only]

Phases, one line each; any failure raises and the exit code is not 0:

  env          the card (name, power limit), torch and nvcc versions
  build        compiles the hand-written kernels from `elasticsearch_tpu_torch/csrc`
               (one nvcc per source, all started together), then the
               host library `csrc/es_native.cc` (g++)
  kernels      each binned kernel against its plain PyTorch version on the card
               (int8 bit-identical, bf16 within one packing quantum) at the
               served shapes: bf16 N=1,048,576 D=128 at Q=256 (cosine and
               clamped) and Q=1, the hybrid knn leg (Q=1, 131,072 x 768), the
               dot index (Q=16, 16,384 x 128 clamped), int8 N=1,048,576
               D=768 at Q=256 and Q=1; each timed per launch and in a burst
               of 50 (CUDA events) beside its bound and one PyTorch call of
               the same product; then each fused IVF probe kernel against
               its plain version (nlist 1024, cap 1472, nprobe 32, Q=256 and
               Q=1; bf16 D=960, int8 D=768, int4 D=768, at Q=256 also with
               skewed and with out-of-range probe ids; D=100 rows and f32
               tiles on the simt variants, bf16 and int8 D=48 and int4
               D=64 and D=288 on the grouped ones), the grouped variants'
               probe plan against its plain version, each timed per launch
               and in a burst beside the bound of its distinct tiles, the
               port's scan route and one bf16 `torch.matmul` over every
               tile row (int8 values or int4 levels on a bf16 copy); then
               both MaxSim kernels against their plain versions at the
               ColBERTv2 shape (N_pad 131,072, cap 256, D 128, W 64, Tq 32;
               Q=256 and Q=1; f32, bf16, int8 and int4 tiles), every launch
               on the variant its shape names (`warp` for bf16, int8 and
               int4 at Tq <= 32, `wmma` for f32 and Tq 128), with small
               caps, Tq 8 and 128, docs with a zero-scale slot inside
               their span, docs with no valid slot, candidate ids outside
               [0, N_pad) and cap 100; timed likewise beside one
               `torch.bmm` of the bf16 queries over a pre-staged bf16 copy
               of the candidate tiles and the staged gather form; then
               `bm25_board` (a score-and-select kernel and a merge
               kernel, one call a batch) against its plain version,
               windows bit for bit, on a synthetic Zipf layout over
               --n-msmarco docs (f32, bf16 and int8 impacts; Q = 32 with a
               repeated word, an out-of-vocabulary word, a query with no
               tile, required 2 and 3, and Q = 1), timed beside its bound,
               the plain version, an `index_put_` pair + `torch.topk` and
               the board route; forced ranges of 64 and 2,048 slots on
               16,384 docs (the window of 100 past the first); then
               the same on the learned-sparse layout over --n-sparse
               docs (30,522
               Zipf-popular token ids, about 120 a doc, weights in (0, 3];
               Q = 32 of 20-120 tokens, Q = 1, and Q = 1 of 300 tokens,
               each entry with its token's boost)
  serve_sift   the port's REST server in-process: a cosine dims=128 index,
               2,000 docs over `_bulk` (checked first by one search on a
               scratch copy of them), then loaded to 1,000,000 SIFT-shaped
               docs through `IndexService.index_many`, one refresh (one
               corpus, on the binned kernel), and 64
               `_search {knn, k: 10}` requests over HTTP: recall@10 against
               exact f32 numpy and the bf16 kernel's launch count (every
               launch on its tma variant); then a
               dot_product index (16,384 docs) through the clamped variant
  serve_documents  the document and index API on sift after its
               concurrent levels: over HTTP, `_bulk` deletes of 10,000 ids
               and `doc` updates of 10,000 vectors, 500 single deletes,
               500 `_update`s and 500 auto-id writes, a `_create` on a live
               id and a stale `if_seq_no` (both 409), then a timed
               `_refresh` (`refresh_s`): the generational path, no
               rebuild: 21,000 tombstones and one L0 seal of 11,000 rows
               (a `[segments] index=sift` line: generations, seals,
               rebuilds avoided, full rebuilds 0, the route's launches);
               the 64 queries at recall@10 >= 0.95 against exact f32 numpy
               over the live documents, no deleted id in a hit, 64 updated
               documents each first for its new vector, `_count` exact,
               `_mget` of deleted (not found) and updated (the new vector)
               ids, the batch-1 answers held to one batch of the same
               queries through the store (ties counted), each request on
               the route its two generations give: no binned launch and
               two exact-route legs (the tombstoned base serves masked
               until a merge compacts it; 2% dead is below the GC
               fraction); then `sift_b` (65,536 x 128, the same mapping):
               12 refreshes of 100 docs seal L0 generations and start
               background merges, whose reasons and final tiers must be
               the merge policy's on the same sequence (a `[segments]
               index=sift_b` line); after `drain()` at most `max_l0` L0
               generations and recall@10 >= 0.95; `POST
               /sift_b/_forcemerge` rebuilds the re-based rows
               (`segment_rewrite`) into one clean generation; then
               `sift,sift_b`, `sift*` and no index at recall@10 >= 0.95
               over the union, each hit's `_index` right, `_shards.total`
               2, sift_b on the binned kernel again and sift on its exact
               legs, `_msearch` of 16 lines equal to the single searches;
               then `DELETE /sift_b` and `/sift`, which must free >= 90%
               of every generation's device bytes, and a search of `sift`
               is a 404
  serve_cohere the same for a 768-d cosine `int8_flat` index with
               `rescore: true` and `_source` disabled (int8 kernel + re-rank)
  serve_gist   a 500,000 x 960 dot_product `ivf` index of unit-normalized
               clustered rows (the fused bf16 kernel, one launch a request,
               recall@10 >= 0.95), then a 65,536 x 960 l2_norm `ivf` index
               (the scan route: no fused launch)
  serve_cohere_ivf  1,000,000 x 768 cosine rows (~64 docs per cluster, the
               reference's quantization-ladder shape) under `int8_ivf` (the fused
               kernel on int8 tiles: routing recall >= 0.95 against the same
               index at nprobe = nlist, recall@10 >= 0.90) and under
               `int4_ivf` (the int4 kernel + exact rescore, recall@10 >= 0.95)
  serve_ivf_compaction  a 131,072-row `int8_ivf` index of the same shape
               built in one refresh; 1% of its docs deleted over `_bulk`
               and a timed refresh: its base sets tombstones, drops its
               router and serves masked (no fused launch) while the merge
               thread is held; then the held merge runs (`drain()`): one
               `tombstone_gc` compaction retrains the router
               (`ivf_background_builds` 1), every request launches
               `ivf_fused_dense` on `grouped` again, recall@10 over the
               live rows >= 0.90 and routing recall >= 0.95
  serve_colbert a hybrid index {emb: 768-d cosine `flat`, colv: rank_vectors
               128-d cosine} of 131,071 ColBERTv2-shaped docs (`int8`, then
               `int4` token tiles): 300 docs over `_bulk`, the rest through
               `Engine.index_many(vectors=, token_vectors=)`, then 64
               `rank: {rrf}` requests over HTTP with a knn and a
               late_interaction sub-search: one `knn_binned_bf16` and one
               `maxsim_dense` (or `maxsim_int4`) launch a request (on the
               `tma` and `warp` variants), the int8
               MaxSim leg's recall@10 >= 0.95 against exact f32 MaxSim over
               the raw tokens (int4, at the reference's oversample 8, is
               logged against that gate and held to >= 0.90), and every
               response equal to RRF recomputed on the host from the two
               legs
  serve_filtered  BASELINE config 5, filtered kNN: a 512-d cosine `flat`
               index of 1,000,000 clustered rows with LAION's metadata
               columns (nsfw keyword, width integer, aesthetic float,
               watermark boolean) from the seed; 64 `_search {knn: {...,
               filter}}` requests over HTTP for each of five filters
               (about 90%, 7%, 1%, 1% and fewer than k rows): recall@10 >=
               0.95 against exact f32 numpy over the passing rows, every
               hit inside its filter (from the generated columns), hits and
               total min(k, passing rows), no binned launch; 16 `knn` +
               `query` and 16 two-element `knn` lists equal to the
               should-sum of their legs recomputed on the host, one binned
               launch a leg; the exact route (`knn.exact` with a [Q, N]
               mask, Q = 1 and 32) timed beside its bound and one bf16
               `torch.mm`, and the card's peak memory over a filtered batch
               of 32; serve_concurrent at C = 1 and 8 over a mix of the
               filters and unfiltered bodies. The node query cache (a
               `bool`'s `filter` clauses) is on throughout, so the
               `filter=` lines' p50 and the concurrent mix time those
               clauses warm. A `cache` line a filter: the first 16
               queries cold (`_cache/clear` before each, untimed) against
               the same 16 as they came in the warm pass, HTTP p50, the
               filter's host time uncached and cached on one reader and
               its share of the p50, the cache's hits and misses over the
               64 (each cached clause missing at most once, the cached
               filter faster); then the search body's part
               (`serve_body_laion`): 64 `knn` bodies each with `sort`,
               `post_filter`, `min_score`, `collapse` with `inner_hits`,
               as `query: {knn}` with a `rescore`, and with `version`,
               `seq_no_primary_term`, `docvalue_fields` and `explain`,
               each held to the unfiltered answer reworked on the host
               from the columns and the engine, one binned launch a
               request and no exact route; a `term` query of 90% of the
               rows sorted by aesthetic, one request of 500 against a
               numpy lexsort and five `search_after` pages of 100 against
               it
  serve_hybrid  BASELINE config 3, hybrid BM25 + kNN by RRF: one shard
               of MS MARCO-shaped passages (a Zipf vocabulary of 200,000
               words, 20-92 words a passage, cut from 8,841,823 to
               --n-msmarco) with a 768-d cosine `flat` embedding each;
               64 queries (6 words of a source passage, its embedding plus
               noise): each lexical leg's window byte-identical to the same
               `match` through `_search`, its top 10 against a float64
               BM25 of the generated tokens, kNN recall@10 >= 0.95, every
               hybrid response (both body forms, `operator: and`, a
               generic `range` leg, text that analyzes to nothing) equal
               to host RRF of its legs, one `bm25_board` call a request
               and at C = 1 and 8 one a batch; then a repeat pass with the
               device rung of the request cache on: 64 cold requests (64
               misses, a board and a binned launch each), then the same 64
               warm (64 hits, no launch, no board kernel, the cold
               response but `took` 0), its `cache` line giving both p50s;
               then the search body's part (`serve_body_msmarco`): 16
               `match` bodies with `highlight` (the tags taken out give
               the passage back, every wrapped span a query term, every
               query-term token wrapped), and 16 `rank: {rrf}` bodies over
               `msmarco,msmarco_b` (a second index of the first 16,384
               passages) and 16 one-index ones with `highlight`, each
               equal to the RRF of its legs' own `_search` responses,
               one binned launch an index
  serve_sparse  learned-sparse retrieval: MS MARCO passage expanded by a
               BERT-wordpiece learned-sparse model (SPLADE, ELSER; 30,522
               token ids, 64-256 tokens a passage, Zipf popularity), cut
               from 8,841,823 to --n-sparse passages, one shard: `tokens`
               rank_features and `emb` 768-d cosine `flat`; 64 hybrid
               `rank: {rrf}` requests (a `sparse_vector`, 16 as
               `weighted_tokens`, and a `knn` sub-search; 20-120 query
               tokens) and 8 of 257-300 tokens: each sparse leg's window
               byte-identical to the host twin, its top 10 against a
               float64 sparse dot (scipy CSR) over the generated arrays,
               bf16 and int8 recall@10 against it, kNN recall@10 >= 0.95,
               every response equal to host RRF of its legs, one
               `bm25_board` call (variant `sparse`) a request and at
               C = 1 and 8 one a batch; then the plain `query:
               {sparse_vector}` host walker on an index of the first
               50,000 passages, byte-identical to the board's window there
  serve_logs   a web-server log index modelled on the Rally `http_logs`
               track (the 1998 World Cup logs, 247,249,096 lines), cut
               to --n-logs lines (100,000): its mapping (`date` with
               `strict_date_optional_time||epoch_second`, `ip`, a `text`
               request with a `keyword` multi-field, an object of
               keywords and a `geo_point`, `dynamic: strict`), lines from
               the seed (about 8 a second over 1998-04-30 to 07-26, Zipf
               client IPs and paths); 2,000 over `_bulk`, the rest
               through `IndexService.index_many(sources=)`. 64 requests
               a kind over HTTP, each answer equal to numpy over the
               generated columns: a day's `range` (ISO bounds, exact
               `track_total_hits`), a two-day range in date math with
               rounding (`||-1d/d`, `||/d`), `term` on `request.raw` (a
               popular and a rare path), a `range` on `clientip`, a day
               sorted by `@timestamp` desc and asc (with `_doc`), each
               with five `search_after` pages, `docvalue_fields` on
               `@timestamp` (`strict_date_optional_time`, `epoch_millis`)
               equal to Python's formatting, `exists` on the `geoip`
               object; then a `dynamic: true` index of 10,000 documents
               over `_bulk` (nested objects, date strings, ints, floats,
               bools), whose `GET /_mapping` must equal the dynamic
               rules' and whose `.keyword` sub-fields and dynamic date
               `term` / `range` find what the documents hold; then two
               time-partitioned indices searched with
               `pre_filter_shard_size=1`, can_match skipping the one
               whose dates miss the day; then aggregations (`size: 0`)
               over the lines and the pair: the track's
               `hourly_agg` (a `date_histogram` by the hour), `terms` on
               `status` with `stats` of `size`, a daily histogram with
               `terms` under it, a `range` of `size` with `avg`,
               `cardinality` of `clientip` at the top and a day, and
               `percentiles`, `filters`, `missing` and `global` (host
               nodes), and the `terms` body over the pair (partial
               states): every count, sum, minimum and maximum equal to
               numpy, each cardinality within three HLL standard errors
               of numpy's exact count, each device-rung answer equal byte
               for byte to the host path's, every eligible node on the
               card (`aggs.*` torch ops, no hand kernel), a repeat of
               `hourly_agg` through the request cache running no op; the
               `[aggs]` line (column build, HTTP p50 a body on the device
               rung and on the host path, the cost router's choice) and an
               `[aggs_op]` line an op (time a call beside its byte bound
               and, for `ord_counts`, `torch.bincount`); then the
               `[aggs_kinds]` line (HTTP p50 over 16 requests a body and
               the part's seconds): sibling pipelines and a `bucket_sort`
               over a daily histogram on the device rung (one device node
               a request, `aggs.*` launches, the profile's engine), parent
               pipelines under it (one host node), `composite` paged with
               `after_key`, `rare_terms`, `significant_terms`, the geo
               grids with bounds and centroids, `top_hits` and
               `top_metrics`, the other metrics, a `terms` script and a
               `scripted_metric`, `auto_date_histogram`,
               `adjacency_matrix` and `sampler`, and over the pair its
               composite, siblings and t-digests, each held to numpy
Every serve phase's node runs with `search.request_cache.device_paths`
false (SERVE_SETTINGS): they send bodies more than once, and each must
reach the card. Each IVF index answers one warm-up search first (the `nprobe: auto` tuner
runs there), then the timed requests; every request must take the fused
route with no exhaustive fallback, every `ivf_fused_dense` and
`ivf_fused_int4` launch its grouped variant. Then one `store.search_many`
of the same queries, a batch of 64 through the router's real probes, must
return the same hits. The `int8_ivf` index then answers one filtered
request, which must fall back to the exhaustive corpus
(`fallback_reason: filtered`), launch no kernel and keep inside its filter.

  serve_concurrent  closed-loop HTTP clients (a thread and a connection
               each, in a child process) against indices the phases above
               built, right after their sequential requests: sift (the bf16
               binned kernel) and cohere `int8_ivf`
               (`ivf_fused_dense/grouped`) at C = 1, 8 and 32, 256 requests
               a level drawn from the phase's 64 queries; colbert int8 (the
               bf16 binned leg and `maxsim_dense/warp`) at C = 1 and 8, 128
               bodies. sift and `int8_ivf` then take two open-loop
               levels: 256 requests at Poisson arrival times (gaps from
               the seed) at 0.5 and 0.9 of the C = 32 level's QPS, sent
               by up to 64 connections, each timed from its arrival.
               Each level logs QPS, p50, p99, the combining
               batcher's counters (batches, requests, mean and max batch,
               top-ups, pipelined batches, its stage times), launches per
               request by kernel and variant, and 429s, and fails when a
               response differs from the same
               query's batch-1 answer beyond the phase's score tolerance
               (a difference confined to tied scores is counted and
               logged as `ties`), a recall@10 falls below the sequential
               one, a hybrid response differs from host RRF of its legs,
               any request is refused or fails, or the largest batch at
               C = 32 is 1 (the batcher did not coalesce). The colbert
               level also checks that the 64 bodies' legs run as one batch
               give the batch-1 RRF answers and the MaxSim recall.
               serve_filtered takes C = 1 and 8 likewise: a filtered
               answer is held to its batch-1 answer within the exact
               route's tolerance, an unfiltered one within one packing
               quantum (a batch holding a filter scores it exactly), and
               the largest batch at C = 8 must exceed 1.
  serve_sharded  BASELINE config 4 at its 8 shards: `number_of_shards: 8`,
               768-d cosine `int8_ivf` rows, ~64 a cluster in each shard as
               serve_cohere_ivf's are in its one, made on the card in
               chunks; 1,000 docs over `_bulk`, the rest through
               `IndexService.index_many` (each id to its murmur3 shard),
               one refresh. The routing hash gives Murmur3HashFunctionTests'
               values, 32 sampled ids lie in the shards the reference names
               (written into this script), and every shard holds as many
               docs as ids hash to it; 64 `_search {knn}` requests over
               HTTP: recall@10 >= 0.90 against exact f32 numpy over the
               whole corpus, routing recall >= 0.95, no shard probing more
               than half its lists, `ivf_fused_dense/grouped` once a shard
               a request and no other launch, `_shards.total` 8;
               a filtered request (1/64 of the docs, on every shard) inside
               its filter at recall@10 >= 0.95; 16 GETs by routing;
               serve_concurrent at C = 1 and 8, one launch a shard a
               batch. Logged beside the one-shard `int8_ivf` index of
               serve_cohere_ivf and the card's name and power limit.
  telemetry    rides the serve phases' indices, `[telemetry]` lines: on
               sift_b after `_forcemerge`, cohere `int8_flat` and cohere
               `int8_ivf` a kNN body with `profile: true` against its
               unprofiled twin (the same hits and launches, the launch
               events naming `knn.binned` / `ivf.fused_probe` once a
               launch, `profile.knn`, the trace with the batch's dispatch
               and finalize spans); the msmarco hybrid body (both legs,
               `bm25.topk` and `knn.binned` events, the queue-wait /
               launch / device-wait split, no device-rung cache hit); a
               serve_logs `size: 0` body (engine `device`, collect > 0);
               after sift's C = 8 level `GET _nodes/stats/telemetry`
               (queue wait one a request, dispatch and sync one a batch
               of the index batcher, p50 and p99 of each); a request
               queued behind sift's held batcher lock and cancelled
               through `POST _tasks/{id}/_cancel` (shed, no launch, the
               reference's 400); `timeout: 1ms` and `terminate_after: 1`
               on sift_b (the same hits, `timed_out` false); and the
               sequential HTTP p50 of 256 sift_b requests at sample rates
               0, 0.01 and 1.0.
  dsl          rides the serve phases' indices, `[dsl]` lines of HTTP
               p50s over DSL_REQUESTS requests a body: on msmarco
               (`dsl_msmarco`) `prefix`, `wildcard`, `regexp`, `fuzzy`,
               `match` with `fuzziness`, `match_phrase_prefix`,
               `query_string` (AND, a phrase, a field wildcard), the URL
               `q` with `df`, `dis_max`, `boosting` and `function_score`,
               each total equal to numpy's over the generated tokens and
               its page in the reference's order, and a term `suggest`
               of a misspelt frequent word; on laion (`dsl_laion`)
               `script_score` with `cosineSimilarity` over the
               aesthetic_gte_6_5 filter against an f64 numpy cosine
               (recall@10 1.0, scores within 1e-5) beside the same filter
               as a `knn` filter (its p50 and exact-route calls), a
               stored script by id, a Painless statement over a `knn`
               clause, `script_fields` and a `_search/template`; on sift
               (`dsl_sift`) `_update` scripts (tags, `+=`, rewritten
               vectors, `ctx.op = 'delete'`), then no deleted id in a kNN
               answer and recall@10 >= 0.95 over the live rows; on
               serve_logs (`dsl_logs`) `prefix` on `request.raw` and
               `query_string` over `status` and `request`, against the
               columns.
  search_api   rides the serve phases' indices, `[search_api]` lines: on
               laion (`search_api_laion`) a scroll of 1,000 a page over
               the aesthetic_gte_6_5 filter (every row once, 67 pages,
               then an empty one), the same sliced 4 ways (disjoint, the
               same union), a match_all scroll start (its ms and RSS
               growth); on sift and sift_b (`search_api_sift`) a `knn`
               with `indices_boost` (the merge of each index's own top 10
               with sift_b's doubled, recall@10 against numpy), a
               `pinned` around a `knn` clause, and a scroll over a copy of
               sift_b that a write, a delete and a refresh between its
               pages leave as it was; on msmarco (`search_api_msmarco`)
               `span_near`, `span_first`, `intervals`, `terms_set`,
               `wrapper` and `more_like_this`, each total equal to
               numpy's over the generated tokens; on serve_logs
               (`search_api_logs`) `geo_distance`, `geo_bounding_box`,
               `geo_polygon`, `geo_shape`, `distance_feature` on a date
               and a point, and a `terms` lookup, against the columns.
  serve_nested documents within documents, `[nested]` lines (HTTP p50
               over 16 requests a body): `qa`, --n-qa questions shaped
               after Rally's `nested` track with 0-8 `nested` answers
               each: `nested` `term` on `answers.user` and `range` on
               `answers.date`, both with inner hits of size 3 and 100, a
               `nested` aggregation of a yearly `date_histogram` with a
               `reverse_nested` inside, and a `nested` / `top_hits` of
               the newest answers, every total, inner hit, bucket and
               listed object numpy's; `chunks`, 4,096 parents with 32,768 chunk
               children (384-d cosine vectors, `nested` entities) routed
               by their parent's id over two shards: `knn` filtered by
               `has_parent` and by `nested` (the exact route: recall@10
               >= 0.95 against numpy over the filter's rows, their count
               numpy's), `has_child` around a `knn` clause (the binned
               kernel; the parents of the clause's own hits) and
               `parent_id`; the percolator, 10,000 stored queries shaped
               after Rally's `percolator` track and 16 documents, each
               hit set the check's own evaluation.
  node_apis    `[node_apis]` lines (the card's name and power limit on
               each): on sift after serve_documents' checks,
               `_delete_by_query` of 10,000 ids (`deleted` and `_count`
               exact) and `_update_by_query` of 10,000 others (a script
               sets `tag`; a `match` counts them), each one refresh on
               the generational path (no full rebuild; `refresh_s`,
               rebuilds avoided), then 64 `knn` queries at recall@10 >=
               0.95 over the live rows with no deleted id (exact legs);
               `_reindex` of 100,000 documents into a
               2-shard `int8_flat` index (`created`, docs a second, 2
               `knn_binned_int8` launches a request, recall@10 >= 0.95
               over the ids it holds); a one-index alias (sift's hits and
               documents) and a two-index one (union recall@10 >= 0.95, a
               document operation a 400); the int8 index closed (`knn` a
               400 `index_closed_exception`, no launch, `_cat/indices`
               `close`) and opened (the same hits, device memory before
               and after); on sift_b (binned) `_async_search` of a `knn`
               body polled to its end (sync hits, one bf16 launch) and
               `_explain` of the top hit with a `knn` clause (within
               BF16_QUANTUM / 2 of `_score`).
               On serve_logs: `PUT _settings` of `max_result_window`
               taking effect, and the HTTP p50 over 16 requests of
               `_field_caps`, `_validate/query`, `_termvectors`,
               `_analyze`, `_search_shards`, `_cluster/health`,
               `_cat/indices`, `_cat/shards` and `GET /_nodes`.

`--binned-only`, `--ivf-only` and `--maxsim-only` run env, build and one
kernel phase (no serving, no ok line): the numbers of PERF.md's
parent-vs-change comparisons, where a parent commit's package runs this
script too (the checks of variants it lacks are skipped).
`--sharded-only` runs env, build and serve_sharded (no ok line);
`--hybrid-only` runs env, build, the bm25_board checks and serve_hybrid
(no ok line); `--sparse-only` the same with serve_sparse;
`--docs-only` runs env, the binned build, serve_sift's sequential
requests and serve_documents (no ok line); `--segments-only` the same
and serve_ivf_compaction, with the IVF build too; `--body-only` runs env, the
binned build, the laion index at --n-laion with its unfiltered requests
and the search body's part (no ok line); `--logs-only` runs env and
serve_logs (no build, no ok line); `--telemetry-only` runs env, the
binned, IVF and BM25 builds and the phases that carry the telemetry part
(below) at the sizes given (no ok line); `--dsl-only` runs env, the
binned and BM25 builds and the phases that carry the dsl part: serve_hybrid,
the laion index with its unfiltered requests, and serve_sift's sequential
requests with serve_documents (no ok line); `--search-api-only` runs
env, the binned and BM25 builds, serve_hybrid, the laion index with the
`[search_api]` part alone, serve_sift's sequential requests with
serve_documents, and serve_logs (no ok line); `--nested-only` runs env,
the binned build and serve_nested (no ok line); `--node-apis-only` runs
env, the binned build, serve_sift's sequential requests with
serve_documents (the part on sift) and the logs index with the part's
host APIs (no ok line). Every phase drops its indices
through `DELETE /{index}`. Each phase's
wall seconds print as a `[timing]` line.

The next-to-last lines are a JSON object with every kernel's numbers and the
card's `nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {...}}. It needs one CUDA card and exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import base64
import calendar
import gc
import http.client
import json
import math
import os
import re
import resource
import statistics
import subprocess
import sys
import threading
import time

from typing import Optional

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


HOLD_CYCLES = 50_000_000        # ~25 ms of the card's clock


def burst_ms(fn, n: int = 50, warmup: int = 3) -> float:
    """CUDA-event time of `n` back-to-back calls, over `n`: a short
    kernel's device time, which a per-launch event pair blurs with the
    host's submission. A sleep kernel holds the card while the host queues
    the n calls, so the events time the card alone, not the host's pace
    (unless the host needs more than ~25 ms for them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


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


def kernel_profile(fn, names, n: int) -> dict:
    """`torch.profiler`'s record of `n` calls of `fn`: for each kernel name
    (a substring of the device kernel's symbol), (launches, device ms)
    a call. A kernel the trace does not show gets (0, 0.0)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {name: [0, 0.0] for name in names}
    for e in prof.key_averages():
        for name in names:
            if name in e.key:
                us = getattr(e, "device_time_total", 0) \
                    or getattr(e, "cuda_time_total", 0)
                out[name][0] += e.count
                out[name][1] += us / 1e3
    return {name: (c / n, ms / n) for name, (c, ms) in out.items()}


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


def phase_build(names=("knn_binned", "ivf_fused", "maxsim", "bm25")) -> None:
    from elasticsearch_tpu_torch import native
    from elasticsearch_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = _build.build(list(names))
    native.build()
    # ptxas: each entry function's (mangled) name, registers and spills
    usage, fn = [], ""
    for ln in (ln for rep in reports.values() for ln in rep.splitlines()):
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "registers" in ln or "spill" in ln:
            usage.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
    log("build", seconds=f"{time.perf_counter() - t0:.1f}",
        ptxas=repr(" | ".join(usage)))


def _binned_case(kernel: str, case: str, run, plain, exact: bool,
                 nbytes: int, ops: int, ops_per_s: float, library=None,
                 time_plain: bool = False) -> dict:
    """One binned kernel at one shape: the kernel against its plain version
    (int8 `torch.equal`, bf16 within one packing quantum of the decoded
    scores), then its per-launch and burst times beside the bound, the
    plain version's time (when `time_plain`) and one PyTorch call's."""
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    got, want = run(), plain()
    torch.cuda.synchronize()
    if exact and not torch.equal(got, want):
        raise AssertionError(f"{kernel} {case}: differs from its plain version "
                             f"in {int((got != want).sum())} packed values")
    err = float(((got & kb.MASK).view(torch.float32)
                 - (want & kb.MASK).view(torch.float32)).abs().max())
    if not err <= BF16_QUANTUM:
        raise AssertionError(f"{kernel} {case}: max |decoded diff| {err} "
                             f"exceeds one quantum {BF16_QUANTUM}")
    del got, want
    f = {"max_abs_err": err, "ms": time_ms(run), "burst_ms": burst_ms(run)}
    f["bound_ms"], f["bound_by"] = bound_ms(nbytes, ops, ops_per_s)
    f["plain_ms"] = (time_ms(plain, iters=5, warmup=1) if time_plain
                     else None)
    f["library_ms"] = time_ms(library) if library else None
    f["library_burst_ms"] = burst_ms(library) if library else None
    log("kernels", kernel=kernel, case=case,
        **{k: (f"{v:.6g}" if isinstance(v, float) else v)
           for k, v in f.items()})
    return f


def phase_binned_kernels(seed: int, dev) -> dict:
    """Both binned kernels against their plain version at the served
    shapes: bf16 1,048,576 x 128 at Q=256 (cosine and clamped) and Q=1,
    the hybrid knn leg (bf16 131,072 x 768, Q=1), the dot index (bf16
    16,384 x 128 clamped, Q=16), int8 1,048,576 x 768 at Q=256 and Q=1."""
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    g = torch.Generator(device=dev).manual_seed(seed)

    def unit(n, d, scale=1.0):
        x = torch.randn(n, d, generator=g, device=dev)
        return (x / x.norm(dim=1, keepdim=True) * scale).to(torch.bfloat16)

    def bf16_case(case, q, c, num_valid, clamp, time_plain=False):
        n_pad, d = c.shape
        valid, tpat = kb._tile_patterns(n_pad, num_valid, dev)
        nq = q.shape[0]
        nbytes = (q.numel() + c.numel()) * 2 + n_pad * 4 \
            + nq * (n_pad // 64) * 4
        return _binned_case(
            kb.KERNEL_BF16, case,
            lambda: kb.binned_packed_bf16(q, c, valid, clamp=clamp),
            lambda: kb.binned_packed_reference(q, c, valid, tpat,
                                               clamp=clamp),
            False, nbytes, 2 * nq * n_pad * d, BF16_OPS_PER_S,
            library=lambda: torch.matmul(q, c.T), time_plain=time_plain)

    n_pad = 1 << 20
    cases = {}
    q, c = unit(256, 128), unit(n_pad, 128)
    cases["bf16_q256"] = bf16_case("Q=256 N=1048576 D=128 cosine", q, c,
                                   n_pad - 1000, False, time_plain=True)
    cases["bf16_q1"] = bf16_case("Q=1 N=1048576 D=128 cosine",
                                 q[:1].contiguous(), c, n_pad - 1000, False)
    c = (c.float() * 8).to(torch.bfloat16)
    cases["bf16_q256_clamped"] = bf16_case(
        "Q=256 N=1048576 D=128 clamped", q, c, n_pad - 1000, True)
    del q, c
    # the hybrid index's knn leg (131,071 docs) and the dot index (16,384)
    cases["bf16_leg"] = bf16_case("Q=1 N=131072 D=768 cosine", unit(1, 768),
                                  unit(1 << 17, 768), (1 << 17) - 1, False)
    cases["bf16_dot"] = bf16_case("Q=16 N=16384 D=128 clamped",
                                  unit(16, 128), unit(1 << 14, 128, 8.0),
                                  1 << 14, True)
    torch.cuda.empty_cache()

    # int8 at the Cohere width; the scales put the dequantized scores
    # around [-3, 3], so the clip at both ends and the padding's zero
    # weight are all exercised
    d = 768
    valid, tpat = kb._tile_patterns(n_pad, n_pad - 1000, dev)
    q8 = torch.randint(-127, 128, (256, d), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    c8 = torch.randint(-127, 128, (n_pad, d), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    qscale = (torch.rand(256, 1, generator=g, device=dev) + 0.5) / 127.0 / 3.0
    rsv = ((torch.rand(1, n_pad, generator=g, device=dev) + 0.5)
           / 127.0 / 3.0) * valid
    for key, nq in (("int8_q256", 256), ("int8_q1", 1)):
        qn, qs = q8[:nq].contiguous(), qscale[:nq].contiguous()
        nbytes = qn.numel() + c8.numel() + nq * 4 + n_pad * 4 \
            + nq * (n_pad // 64) * 4
        # torch._int_mm takes more than 16 rows: at Q=1 the library call
        # multiplies the query padded with zero rows to 32
        ql = qn if nq > 16 else torch.cat(
            [qn, torch.zeros(32 - nq, d, dtype=torch.int8, device=dev)])
        cases[key] = _binned_case(
            kb.KERNEL_INT8, f"Q={nq} N=1048576 D=768",
            lambda: kb.binned_packed_int8(qn, c8, qs, rsv),
            lambda: kb.binned_packed_reference(qn, c8, rsv, tpat, qscale=qs),
            True, nbytes, 2 * nq * n_pad * d, INT8_OPS_PER_S,
            library=lambda: torch._int_mm(ql, c8.T),
            time_plain=nq == 256)
    del q8, c8
    torch.cuda.empty_cache()

    out = {}
    for name, main, replaces in (
            (kb.KERNEL_BF16, "bf16_q256", "pallas_knn_binned.py:76"),
            (kb.KERNEL_INT8, "int8_q256", "pallas_knn_binned.py:93")):
        c = cases[main]
        out[name] = {
            "name": name, "route": "cuda",
            "source": "elasticsearch_tpu_torch/csrc/knn_binned.cu",
            "replaces": f"elasticsearch_tpu/ops/{replaces}",
            "max_abs_err": max(f["max_abs_err"] for k, f in cases.items()
                               if k.startswith(main[:4])),
            "ms": c["ms"], "burst_ms": c["burst_ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
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


def _ivf_check(label, got, want) -> float:
    """NEG_INF slots identical, the rest within 1e-5 of the largest
    |score|; returns the max |diff|."""
    neg = want <= -1e37
    if not torch.equal(got <= -1e37, neg) or \
            not bool((got[neg] == want[neg]).all()):
        raise AssertionError(f"ivf {label}: NEG_INF slots differ from the "
                             f"plain version")
    if bool(neg.all()):
        return 0.0
    err = float((got[~neg] - want[~neg]).abs().max())
    tol = 1e-5 * max(1.0, float(want[~neg].abs().max()))
    if not err <= tol:
        raise AssertionError(f"ivf {label}: max |diff| {err} exceeds {tol}")
    return err


def _ivf_expected(fused, q, ivf, ids):
    """The plain version's board over the in-range probe ids, and -3e38
    across the rows of out-of-range ones (the kernels' rule; the plain
    version would index with them)."""
    nlist = ivf.parts.shape[0]
    bad = (ids < 0) | (ids >= nlist)
    want = fused.probe_board_reference(q, ivf, ids.clamp(0, nlist - 1))
    return torch.where(bad[:, :, None], torch.full_like(want, -3.0e38), want)


def _plan_check(fused, ids, nlist: int) -> int:
    """The plan kernel against `probe_plan_reference`: the same items, and
    within each partition the same entries (as a set: the kernel scatters
    with atomics). Returns the number of items."""
    entries, items = fused.probe_plan(ids, nlist)
    want_e, want_i, _ = fused.probe_plan_reference(ids.cpu(), nlist)
    flat = ids.reshape(-1).long().cpu()
    n = flat.numel()

    def by_partition(e):
        e = e.long().cpu()
        return torch.sort(flat[e] * n + e).values

    if not torch.equal(items.cpu(), want_i) or \
            not torch.equal(by_partition(entries), by_partition(want_e)):
        raise AssertionError(f"probe plan of {tuple(ids.shape)} ids over "
                             f"{nlist} partitions differs from its plain "
                             f"version")
    return len(want_i)


def _bf16_rows(parts, d: int):
    """Every tile row as bf16 [nlist * cap, d]: int8 values, or int4
    levels in dim order (the codec's even and odd planes interleaved)."""
    from elasticsearch_tpu_torch.quant import codec as quant_codec
    if parts.dtype != torch.uint8:
        return parts.view(-1, d).to(torch.bfloat16)
    lo, hi = quant_codec.int4_planes(parts.view(-1, d // 2), torch.bfloat16)
    return torch.stack([lo, hi], dim=-1).view(-1, d)


def _plan_burst_ms(fused, ids, nlist: int) -> float:
    """Burst time of the grouped variant's plan kernel alone (one block)."""
    n = ids.numel()
    bound = fused.item_bound(1, n, nlist)
    scratch = fused._plan_scratch(n, bound, ids.device)
    lib = fused._lib()
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    return burst_ms(lambda: lib.ivf_probe_plan(
        ids.data_ptr(), scratch.data_ptr(), None, n, nlist, 1, bound, stream))


def _skewed_ids(g, dev, nq, nprobe, nlist, hot=(5, 17, 200)):
    """Every query probes the same few partitions, then random ones: each
    hot partition has nq entries (more than one item past N_MAX)."""
    ids = torch.randint(0, nlist, (nq, nprobe), generator=g, device=dev,
                        dtype=torch.int32)
    ids[:, :len(hot)] = torch.tensor(hot, dtype=torch.int32, device=dev)
    return ids


def _bad_ids(g, dev, nq, nprobe, nlist):
    """Random ids with out-of-range ones (-1, nlist, 2^30) mixed in."""
    ids = torch.randint(0, nlist, (nq, nprobe), generator=g, device=dev,
                        dtype=torch.int32)
    bad = torch.tensor([-1, nlist, 1 << 30], dtype=torch.int32, device=dev)
    pick = torch.rand(nq, nprobe, generator=g, device=dev) < 0.1
    return torch.where(pick, bad[torch.randint(0, 3, (nq, nprobe),
                                                generator=g, device=dev)],
                       ids)


def _ivf_case(g, dev, dtype, d, nlist=1024, cap=1472, nprobe=32,
              queries=(256, 1), timed=True):
    """One tile type at one width: the kernel against its plain version at
    each query count (NEG_INF slots identical, the rest within 1e-5 of the
    largest |score|), then, at the first query count, skewed probes (a few
    partitions probed by every query) and out-of-range probe ids, untimed;
    then, when `timed`, CUDA-event times per launch and in a burst beside
    the plain version, the scan route, one bf16 `torch.matmul` of the
    queries against every tile row and the bound of the
    distinct tiles. Where the package has the grouped variant's probe
    plan, the plan kernel is held against its plain version too."""
    from elasticsearch_tpu_torch.ops import ivf_fused as fused
    from elasticsearch_tpu_torch.ops import knn_ivf
    ivf = _ivf_partitions(g, dev, dtype, nlist, cap, d)
    out = {"max_abs_err": 0.0}
    has_plan = hasattr(fused, "probe_plan")    # absent in the first port
    for nq in queries:
        q = torch.randn(nq, d, generator=g, device=dev)
        q = q / q.norm(dim=1, keepdim=True)
        ids = torch.randint(0, nlist, (nq, nprobe), generator=g, device=dev,
                            dtype=torch.int32)
        cases = [(f"{dtype} D={d} Q={nq}", ids)]
        if nq == queries[0]:
            cases += [(f"{dtype} D={d} Q={nq} skewed",
                       _skewed_ids(g, dev, nq, nprobe, nlist)),
                      (f"{dtype} D={d} Q={nq} out-of-range",
                       _bad_ids(g, dev, nq, nprobe, nlist))]
        for label, case_ids in cases:
            got = fused.probe_board(q, ivf, case_ids)
            want = _ivf_expected(fused, q, ivf, case_ids)
            torch.cuda.synchronize()
            out["max_abs_err"] = max(out["max_abs_err"],
                                     _ivf_check(label, got, want))
            del got, want
            if has_plan and nq > 1:
                out[f"items_{label.split()[-1]}"] = _plan_check(
                    fused, case_ids, nlist)
        if not timed:
            continue
        if has_plan and nq > 1:
            out["plan_burst_ms"] = _plan_burst_ms(fused, ids, nlist)
        run = lambda: fused.probe_board(q, ivf, ids)  # noqa: E731
        out[f"q{nq}_ms"] = time_ms(run)
        out[f"q{nq}_burst_ms"] = burst_ms(run)
        if nq == queries[0]:
            out["plain_ms"] = time_ms(
                lambda: fused.probe_board_reference(q, ivf, ids),
                iters=3, warmup=1)
            out["scan_ms"] = time_ms(
                lambda: knn_ivf.score_probes(q, ivf, ids, 10), iters=3,
                warmup=1)
            # one PyTorch call over every tile row, the same products (int8
            # and int4 tiles: on a bf16 copy widened outside the timing)
            flat = _bf16_rows(ivf.parts, d)
            qb = q.to(torch.bfloat16)
            out["library_ms"] = time_ms(lambda: torch.matmul(qb, flat.T))
            out["library_burst_ms"] = burst_ms(
                lambda: torch.matmul(qb, flat.T), n=10)
            del flat
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


def _expect_variant(fused, label, dtype, d) -> None:
    """Every launch since the last reset took the variant its plan names:
    grouped for bf16, int8 and int4 rows of a multiple of 16 bytes, simt
    for the rest (packages without a kernel's variants count none: the
    first port, and int4 before its grouped variant)."""
    from elasticsearch_tpu_torch.ops import dispatch
    int4 = dtype == torch.uint8
    if not hasattr(fused, "VARIANT_GROUPED") or \
            (int4 and not hasattr(fused, "int4_k_order")):
        return
    row_bytes = d // 2 if int4 else d * dtype.itemsize
    grouped = dtype != torch.float32 and row_bytes % 16 == 0
    want = fused.VARIANT_GROUPED if grouped else fused.VARIANT_SIMT
    kernel = fused.KERNEL_INT4 if int4 else fused.KERNEL_DENSE
    got = {k: c for k, c in dispatch.variant_launches().items() if c}
    if set(got) != {f"{kernel}/{want}"}:
        raise AssertionError(f"ivf {label}: variant launches {got}, "
                             f"expected only {want}")


def phase_ivf_kernels(seed: int, dev) -> dict:
    """Both fused IVF probe kernels against their plain versions at the
    main path's layout (1M rows at slack 1.5: nlist 1024, cap 1472), and
    the launches of each kernel's variants."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import ivf_fused as fused
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    cases = {}
    for label, dtype, d in (("bf16_960", torch.bfloat16, 960),
                            ("int8_768", torch.int8, 768),
                            ("int4_768", torch.uint8, 768)):
        dispatch.reset_launches()
        cases[label] = _ivf_case(g, dev, dtype, d)
        log("kernels", kernel=(fused.KERNEL_INT4 if dtype == torch.uint8
                               else fused.KERNEL_DENSE), case=label,
            nlist=1024, cap=1472, nprobe=32,
            **{k: (f"{v:.6g}" if isinstance(v, float) else v)
               for k, v in cases[label].items()},
            variants=json.dumps(dispatch.variant_launches()),
            scan="the port's scan route (knn_ivf.score_probes: per-slot "
                 "gather + einsum + top-k merge)",
            library="torch.matmul of the bf16 queries against every tile "
                    "row" + ("" if dtype == torch.bfloat16 else
                             " (a bf16 copy of the tiles' levels, widened "
                             "outside the timing)"))
        _expect_variant(fused, label, dtype, d)
    # rows whose bytes are not a multiple of 16 take the simt variants'
    # scalar paths, f32 tiles the simt variant; bf16 and int8 d = 48 and
    # int4 d = 64 (32 bytes) and d = 288 (144 bytes) at cap 200 exercise a
    # partial 128-byte step and a ragged last chunk on the grouped ones
    for label, dtype, d in (("f32_100", torch.float32, 100),
                            ("bf16_100", torch.bfloat16, 100),
                            ("int8_100", torch.int8, 100),
                            ("int4_100", torch.uint8, 100),
                            ("f32_64", torch.float32, 64),
                            ("bf16_48", torch.bfloat16, 48),
                            ("int8_48", torch.int8, 48),
                            ("int4_64", torch.uint8, 64),
                            ("int4_288", torch.uint8, 288)):
        dispatch.reset_launches()
        cases[label] = _ivf_case(g, dev, dtype, d, nlist=64, cap=200,
                                 nprobe=8, queries=(37, 1), timed=False)
        log("kernels", case=label, max_abs_err=cases[label]["max_abs_err"],
            variants=json.dumps(dispatch.variant_launches()))
        _expect_variant(fused, label, dtype, d)
    out = {}
    for name, main, extra in (
            (fused.KERNEL_DENSE, "bf16_960", ("int8_768", "f32_100",
                                              "bf16_100", "int8_100",
                                              "f32_64", "bf16_48",
                                              "int8_48")),
            (fused.KERNEL_INT4, "int4_768", ("int4_100", "int4_64",
                                             "int4_288"))):
        c = cases[main]
        out[name] = {
            "name": name, "route": "cuda",
            "source": "elasticsearch_tpu_torch/csrc/ivf_fused.cu",
            "replaces": ("elasticsearch_tpu/ops/pallas_ivf_fused.py:84"
                         if name == fused.KERNEL_DENSE else
                         "elasticsearch_tpu/ops/pallas_ivf_fused.py:98"),
            "max_abs_err": max(cases[x]["max_abs_err"]
                               for x in (main, *extra)),
            "ms": c["q256_ms"], "burst_ms": c["q256_burst_ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "scan_ms": c["scan_ms"]}
    return out


def colbert_counts(rng, n: int) -> np.ndarray:
    """Tokens per doc: ColBERTv2's doc_maxlen 180 caps them, 8 floors
    them, mean about 70."""
    return np.clip(np.rint(rng.gamma(4.0, 17.5, n)), 8, 180).astype(np.int64)


def _token_tile(g, dev, dtype, counts: torch.Tensor, n_pad: int, cap: int,
                d: int):
    """A ragged [n_pad, cap, W] token tile and its scales: doc i holds
    counts[i] valid slots; the rest, and rows len(counts).., scale 0."""
    n = len(counts)
    w = d // 2 if dtype == torch.uint8 else d
    valid = torch.zeros(n_pad, cap, dtype=torch.bool, device=dev)
    valid[:n] = torch.arange(cap, device=dev)[None, :] < counts[:, None]
    if dtype in (torch.int8, torch.uint8):
        lo, hi = (-127, 128) if dtype == torch.int8 else (0, 256)
        toks = torch.empty(n_pad, cap, w, dtype=dtype, device=dev).random_(
            lo, hi, generator=g)
        scales = (torch.rand(n_pad, cap, generator=g, device=dev) + 0.5) \
            / 127 / d ** 0.5
    else:
        toks = torch.randn(n_pad, cap, w, generator=g, device=dev,
                           dtype=dtype) / d ** 0.5
        scales = torch.ones(n_pad, cap, device=dev)
    return toks, torch.where(valid, scales, torch.zeros_like(scales))


def staged_maxsim(ids, q, toks, scales):
    """The staged gather form, the yardstick of the MaxSim kernels: gather
    the [Q, W, cap, W] candidate tiles, one bf16 einsum, mask, max, sum."""
    from elasticsearch_tpu_torch.quant import codec as quant_codec
    bf16 = torch.bfloat16
    cand = ids.long()
    t, s = toks[cand], scales[cand][:, :, None, :]
    if toks.dtype == torch.uint8:
        lo, hi = quant_codec.int4_planes(t, bf16)
        dots = (torch.einsum("qtd,qwcd->qwtc", q[:, :, 0::2].to(bf16), lo)
                .float()
                + torch.einsum("qtd,qwcd->qwtc", q[:, :, 1::2].to(bf16), hi)
                .float())
    else:
        dots = torch.einsum("qtd,qwcd->qwtc", q.to(bf16), t.to(bf16)).float()
    return torch.where(s > 0, dots * s, -3.0e38).amax(-1).sum(-1)


def _maxsim_check(label, got, want) -> float:
    """Padding candidates <= -1e38 in both, the rest within 1e-5 of the
    largest |score|; returns the max |diff|."""
    neg = want <= -1e38
    if not torch.equal(got <= -1e38, neg):
        raise AssertionError(f"maxsim {label}: padding slots differ from "
                             f"the plain version")
    err = float((got[~neg] - want[~neg]).abs().max())
    tol = 1e-5 * max(1.0, float(want[~neg].abs().max()))
    if not err <= tol:
        raise AssertionError(f"maxsim {label}: max |diff| {err} exceeds {tol}")
    return err


def _expect_maxsim_variant(label, dtype, tq, n) -> None:
    """The n launches since the last reset took the variant their shape
    names at D = 128: `warp` for bf16, int8 and int4 tiles at Tq <= 32,
    `wmma` for f32 tiles and wider queries (a package without the variants
    counts none)."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import maxsim
    if not hasattr(maxsim, "VARIANT_WARP"):
        return
    warp = dtype != torch.float32 and tq <= 32
    want = maxsim.VARIANT_WARP if warp else maxsim.VARIANT_WMMA
    kernel = (maxsim.KERNEL_INT4 if dtype == torch.uint8
              else maxsim.KERNEL_DENSE)
    got = {k: c for k, c in dispatch.variant_launches().items() if c}
    if got != {f"{kernel}/{want}": n}:
        raise AssertionError(f"maxsim {label}: variant launches {got}, "
                             f"expected {n} on {want}")


def _bmm_library(ids, q, toks):
    """One `torch.bmm` of the bf16 queries [Q, Tq, D] over a bf16 copy of
    the [Q, W * cap, D] candidate tiles (int8 values, int4 levels in dim
    order), staged outside the timing: the MaxSim board's matrix product
    without its gather, scale, mask, max and sum. Per-launch and burst
    ms."""
    from elasticsearch_tpu_torch.quant import codec as quant_codec
    bf16 = torch.bfloat16
    t = toks[ids.long()]                             # [Q, W, cap, Wt]
    if toks.dtype == torch.uint8:
        lo, hi = quant_codec.int4_planes(t, bf16)
        t = torch.stack([lo, hi], dim=-1)
        del lo, hi
    staged = t.to(bf16).reshape(q.shape[0], -1, q.shape[2])
    del t
    qb = q.to(bf16)
    run = lambda: torch.bmm(qb, staged.transpose(1, 2))  # noqa: E731
    return time_ms(run), burst_ms(run, n=10)


def _maxsim_case(g, dev, dtype, counts, n_pad, cap, tq, queries, w=64,
                 d=128, timed=False):
    """One tile type: the kernel against its plain version at each query
    count (a few candidates on the padding row), on the variant its shape
    names; when `timed`, CUDA-event times at the first query count beside
    the plain version, one `torch.bmm` over the staged candidate tiles, the
    staged gather form and the bound of the distinct candidates' valid
    rows."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import maxsim
    n = len(counts)
    toks, scales = _token_tile(g, dev, dtype, counts, n_pad, cap, d)
    out = {"max_abs_err": 0.0}
    for nq in queries:
        q = torch.randn(nq, tq, d, generator=g, device=dev)
        q = q / q.norm(dim=2, keepdim=True)
        ids = torch.randint(0, n, (nq, w), generator=g, device=dev,
                            dtype=torch.int32)
        ids[0, :4] = n                   # the all-zero padding row
        label = f"{dtype} cap={cap} Tq={tq} Q={nq}"
        dispatch.reset_launches()
        got = maxsim.maxsim_rescore(ids, q, toks, scales)
        _expect_maxsim_variant(label, dtype, tq, 1)
        want = maxsim.maxsim_reference(ids, q, toks, scales)
        torch.cuda.synchronize()
        if not bool((got[0, :4] <= -1e38).all()):
            raise AssertionError("maxsim: padding candidates above -1e38")
        out["max_abs_err"] = max(out["max_abs_err"], _maxsim_check(
            label, got, want))
        del got, want
        if not timed:
            continue
        run = lambda: maxsim.maxsim_rescore(ids, q, toks, scales)  # noqa: E731
        out[f"q{nq}_ms"] = time_ms(run)
        out[f"q{nq}_burst_ms"] = burst_ms(run)
        if nq != queries[0]:
            continue
        out["plain_ms"] = time_ms(
            lambda: maxsim.maxsim_reference(ids, q, toks, scales),
            iters=3, warmup=1)
        out["staged_ms"] = time_ms(
            lambda: staged_maxsim(ids, q, toks, scales), iters=5, warmup=1)
        out["library_ms"], out["library_burst_ms"] = _bmm_library(ids, q,
                                                                  toks)
        torch.cuda.empty_cache()
        docs = torch.unique(ids[ids < n].long())
        valid = int(counts[docs].sum())
        row_bytes = toks.shape[2] * toks.element_size()
        nbytes = (valid * row_bytes + len(docs) * cap * 4 + q.numel() * 4
                  + 2 * ids.numel() * 4)
        ops = 2 * tq * d * int(counts[ids[ids < n].long()].sum())
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, ops,
                                                    BF16_OPS_PER_S)
        out["distinct_docs"] = len(docs)
        out["bound_bytes"] = nbytes
    del toks, scales
    torch.cuda.empty_cache()
    return out


def _maxsim_hard_case(g, dev, dtype, cap: int) -> float:
    """The spans the warp variant must get right, against the plain version
    at Tq 32, D 128, 4,096 tile rows of `cap` slots (3,000 docs of 1..cap
    tokens): docs with a zero-scale slot inside their span (still masked),
    docs with no valid slot, and candidate ids outside [0, N_pad), which
    the plain version cannot index: those must score <= -1e38 (checked
    directly), the rest of their rows match the plain version with the
    padding row in their place. Returns the max |diff|."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import maxsim
    n, n_pad = 3000, 4096
    counts = torch.randint(1, cap + 1, (n,), generator=g, device=dev)
    toks, scales = _token_tile(g, dev, dtype, counts, n_pad, cap, 128)
    holes = torch.arange(600, device=dev)
    slot = (torch.rand(600, generator=g, device=dev)
            * (counts[:600] - 1).float()).long()
    scales[holes, slot] = 0.0            # a hole inside the span (< count - 1)
    scales[600:700] = 0.0                # docs with no valid slot
    bad = torch.tensor([-1, n_pad, n_pad + 7, 2 ** 31 - 1, -2 ** 31],
                       dtype=torch.int32, device=dev)
    err = 0.0
    for nq in (37, 1):
        q = torch.randn(nq, 32, 128, generator=g, device=dev)
        q = q / q.norm(dim=2, keepdim=True)
        ids = torch.randint(0, 700, (nq, 64), generator=g, device=dev,
                            dtype=torch.int32)
        ids[:, ::4] = torch.randint(0, n, (nq, 16), generator=g, device=dev,
                                    dtype=torch.int32)
        ids[:, 2] = 600 + torch.arange(nq, device=dev) % 100   # empty docs
        ids[0, 1:2] = bad[:1]
        ids[0, 3:7] = bad[1:]
        ids[-1, 50:55] = bad
        oob = (ids < 0) | (ids >= n_pad)
        label = f"{dtype} hard cap={cap} Q={nq}"
        dispatch.reset_launches()
        got = maxsim.maxsim_rescore(ids, q, toks, scales)
        _expect_maxsim_variant(label, dtype, 32, 1)
        want = maxsim.maxsim_reference(
            torch.where(oob, torch.full_like(ids, n), ids), q, toks, scales)
        torch.cuda.synchronize()
        if not bool((got[oob] <= -1e38).all()):
            raise AssertionError(f"maxsim {label}: out-of-range ids above "
                                 f"-1e38")
        err = max(err, _maxsim_check(label, got, want))
    del toks, scales
    torch.cuda.empty_cache()
    return err


def phase_maxsim_kernels(seed: int, dev) -> dict:
    """Both MaxSim kernels against their plain versions at the served
    ColBERTv2 shape: N_pad 131,072, cap 256, D 128, W 64, Tq 32; then the
    small, wide and hard cases."""
    from elasticsearch_tpu_torch.ops import maxsim
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    counts = torch.from_numpy(colbert_counts(
        np.random.default_rng(seed + 4), (1 << 17) - 1)).to(dev)
    cases = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                         ("int8", torch.int8), ("int4", torch.uint8)):
        cases[label] = _maxsim_case(g, dev, dtype, counts, 1 << 17, 256, 32,
                                    (256, 1), timed=True)
        log("kernels", kernel=(maxsim.KERNEL_INT4 if dtype == torch.uint8
                               else maxsim.KERNEL_DENSE), case=label,
            n_pad=1 << 17, cap=256, D=128, W=64, Tq=32,
            **{k: (f"{v:.6g}" if isinstance(v, float) else v)
               for k, v in cases[label].items()},
            library="torch.bmm of the bf16 queries over a pre-staged bf16 "
                    "copy of the [Q, W*cap, D] candidate tiles (staging "
                    "untimed)",
            staged="staged gather (toks[ids] + bf16 einsum + mask + amax "
                   "+ sum)")
    # small cap, the shortest and the widest query; the hard spans
    small = torch.randint(1, 9, (3000,), generator=g, device=dev)
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                         ("int8", torch.int8), ("int4", torch.uint8)):
        for cap, tq, cnt in ((8, 32, small), (256, 8, counts[:3000]),
                             (256, 128, counts[:3000])):
            key = f"{label}_cap{cap}_tq{tq}"
            cases[key] = _maxsim_case(g, dev, dtype, cnt, 4096, cap, tq,
                                      (37, 1))
            log("kernels", case=key, max_abs_err=cases[key]["max_abs_err"])
        for cap in (100, 256):
            key = f"{label}_hard_cap{cap}"
            cases[key] = {"max_abs_err": _maxsim_hard_case(g, dev, dtype,
                                                           cap)}
            log("kernels", case=key, max_abs_err=cases[key]["max_abs_err"])
    out = {}
    for name, main, extra in (
            (maxsim.KERNEL_DENSE, "int8", ("f32", "bf16")),
            (maxsim.KERNEL_INT4, "int4", ())):
        errs = [c["max_abs_err"] for key, c in cases.items()
                if key.split("_")[0] in (main, *extra)]
        c = cases[main]
        out[name] = {
            "name": name, "route": "cuda",
            "source": "elasticsearch_tpu_torch/csrc/maxsim.cu",
            "replaces": ("elasticsearch_tpu/ops/pallas_maxsim.py:68"
                         if name == maxsim.KERNEL_DENSE else
                         "elasticsearch_tpu/ops/pallas_maxsim.py:83"),
            "max_abs_err": max(errs), "ms": c["q256_ms"],
            "burst_ms": c["q256_burst_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "staged_ms": c["staged_ms"]}
    return out


class Client:
    def __init__(self, port: int):
        self.port = port
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def req(self, method, path, body=None, ndjson=False, headers=None):
        if body is None:
            raw = b""
        elif ndjson:
            raw = b"\n".join(json.dumps(x).encode() for x in body) + b"\n"
        else:
            raw = json.dumps(body).encode()
        self.conn.request(method, path, body=raw,
                          headers={"content-type": "application/json",
                                   **(headers or {})})
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
    """Create, bulk-load `first` docs over HTTP (checked by one search on
    a scratch copy, `small_index_check`), load the rest through
    `IndexService.index_many`, refresh once, optionally answer
    one warm-up search, then answer every query over HTTP, then once more
    straight through the index's kNN store (no HTTP, no JSON) after the
    launch counts were read. `kernel` is the one kernel each request must launch once,
    or None for a route that launches none; a binned kernel's launches
    must all take its tma variant. Returns (recall@k, HTTP p50 ms, store
    p50 ms, ingest s, launches, and the HTTP requests' hits, scores and
    exact top-k)."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    body = {"settings": dict(settings or {}, number_of_shards=1),
            "mappings": mapping}
    client.ok("PUT", f"/{name}", body)
    n, field = len(vectors), "vec"
    ops = []
    for i in range(min(first, n)):
        ops += [{"index": {"_id": str(i)}}, {field: vectors[i].tolist()}]

    def small_search(path):
        small_q = vectors[7] + 0.01
        hits = client.ok("POST", path, {"knn": {
            "field": field, "query_vector": small_q.tolist(), "k": k,
            "num_candidates": 100}})["hits"]["hits"]
        want = exact_top(vectors[:first], small_q[None, :], k, metric)[0]
        got = [int(h["_id"]) for h in hits]
        # the query sits next to doc 7: it must rank first, and the rest
        # must mostly agree with exact f32 (cluster mates lie close)
        if got[0] != 7 or len(set(got) & set(want.tolist())) < k // 2:
            raise AssertionError(f"small-index search: got {got}, "
                                 f"want {want}")

    small_index_check(client, name, body, ops, small_search)
    resp = client.ok("POST", f"/{name}/_bulk", ops, ndjson=True)
    if resp["errors"]:
        raise AssertionError(f"bulk errors: {resp['items'][:3]}")

    t0 = time.perf_counter()
    if n > first:
        node.index(name).index_many(
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
    multi = node.index(name).vector_store
    dispatch.reset_launches()
    stats0 = dict(store.knn_stats)
    lat, got, got_scores = [], [], []
    for qv in queries:
        t = time.perf_counter()
        resp = client.ok("POST", f"/{name}/_search", knn_body(field, qv, k))
        lat.append((time.perf_counter() - t) * 1e3)
        got.append([int(h["_id"]) for h in resp["hits"]["hits"]])
        got_scores.append([h["_score"] for h in resp["hits"]["hits"]])
        if not all(np.isfinite(h["_score"]) for h in resp["hits"]["hits"]) \
                or len(got[-1]) != k:
            raise AssertionError(f"bad hits: {resp['hits']}")
    launches = dispatch.launches()
    variants = dispatch.variant_launches()
    stats = {key: v - stats0[key] for key, v in store.knn_stats.items()}
    store_lat = []
    for qv in queries:
        t = time.perf_counter()
        multi.search(field, qv, k)        # lands results on the host
        store_lat.append((time.perf_counter() - t) * 1e3)
    want = {} if kernel is None else {kernel: len(queries)}
    if {n: c for n, c in launches.items() if c} != want:
        raise AssertionError(f"launches {launches} for {len(queries)} "
                             f"requests; expected {want}")
    _expect_served_variant(kernel, variants, len(queries))
    truth = exact_top(vectors, queries, k, metric)
    recall = float(np.mean([len(set(g) & set(t.tolist())) / k
                            for g, t in zip(got, truth)]))
    return (recall, statistics.median(lat), statistics.median(store_lat),
            ingest_s, launches, {"hits": got, "scores": got_scores,
                                 "stats": stats, "truth": truth})


def small_index_check(client, name: str, body: dict, ops: list,
                      check) -> None:
    """A serve phase's check of its first documents on a scratch index
    `{name}_small` made like `name` (`body`): the same `_bulk` `ops`, a
    refresh and `check(path)` with the scratch index's `_search` path,
    then `DELETE`. The phase's own index takes the same `_bulk` and the
    rest of its documents before its one refresh, so each vector field
    builds one corpus: a refresh between the two loads would leave the
    rest as one sealed generation, served on the exact route until a
    `_forcemerge`."""
    small = f"{name}_small"
    client.ok("PUT", f"/{small}", body)
    resp = client.ok("POST", f"/{small}/_bulk", ops, ndjson=True)
    if resp["errors"]:
        raise AssertionError(f"bulk errors: {resp['items'][:3]}")
    client.ok("POST", f"/{small}/_refresh")
    check(f"/{small}/_search")
    drop_index(client, small)


def knn_body(field: str, qv: np.ndarray, k: int = 10) -> dict:
    """The `_search {knn}` body of the serve phases' requests."""
    return {"knn": {"field": field, "query_vector": qv.tolist(), "k": k,
                    "num_candidates": 100}, "size": k}


def _expect_served_variant(kernel, variants, n: int) -> None:
    """Every binned launch of served requests takes the tma variant, every
    fused IVF launch (dense and int4) the grouped one."""
    from elasticsearch_tpu_torch.ops import ivf_fused as fused
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    variant = {kb.KERNEL_BF16: kb.VARIANT_TMA, kb.KERNEL_INT8: kb.VARIANT_TMA,
               fused.KERNEL_DENSE: fused.VARIANT_GROUPED,
               fused.KERNEL_INT4: fused.VARIANT_GROUPED}.get(kernel)
    want = {f"{kernel}/{variant}": n} if variant else {}
    if {name: c for name, c in variants.items() if c} != want:
        raise AssertionError(f"variant launches {variants}; expected {want}")


CONCURRENT_REQUESTS = 256
# the serve phases measure the device path, and most send a body more than
# once (serve_concurrent's levels reuse their bodies): their nodes run with
# the device rung of the request cache off, so every request reaches the
# card; serve_hybrid turns it on for its repeat pass
SERVE_SETTINGS = {"search.request_cache.device_paths": "false"}
COLD_REQUESTS = 16      # serve_filtered's cold requests a filter
# connections of an open-loop level: enough that a request finds one free
OPEN_LOOP_CLIENTS = 64


# the HTTP clients, run in a child process so that they do not share the
# server's interpreter lock: argv port, path, clients, n, rate, seed; stdin
# the request bodies as a JSON list of JSON strings; stdout {"wall": s,
# "out": [[status, response text, ms], ...] by request, "errors": [...]}.
# rate 0 is a closed loop; rate > 0 schedules request j at a Poisson
# arrival time (exponential gaps at `rate` a second from `seed`) and times
# it from then, so a request that waited for a free client counts the wait
_CLIENTS = r"""
import http.client, json, random, sys, threading, time
port, path, clients, n = (int(sys.argv[1]), sys.argv[2], int(sys.argv[3]),
                          int(sys.argv[4]))
rate, seed = float(sys.argv[5]), int(sys.argv[6])
raw = [b.encode() for b in json.load(sys.stdin)]
tickets, lock = iter(range(n)), threading.Lock()
out, errors = [None] * n, []
start = threading.Barrier(clients + 1)
gaps = random.Random(seed)
arrival, at = [], 0.0
for _ in range(n):
    at += gaps.expovariate(rate) if rate > 0 else 0.0
    arrival.append(at)
t0 = [0.0]

def client():
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        start.wait()
        while True:
            with lock:
                j = next(tickets, None)
            if j is None:
                return
            t = time.perf_counter()
            if rate > 0:
                time.sleep(max(t0[0] + arrival[j] - t, 0.0))
                t = t0[0] + arrival[j]
            conn.request("POST", path, body=raw[j % len(raw)],
                         headers={"content-type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            out[j] = [resp.status, data.decode(),
                      (time.perf_counter() - t) * 1e3]
    except Exception as e:
        errors.append(repr(e))
    finally:
        conn.close()

threads = [threading.Thread(target=client) for _ in range(clients)]
for t in threads:
    t.start()
t0[0] = time.perf_counter() + 0.01
start.wait()
for t in threads:
    t.join()
json.dump({"wall": time.perf_counter() - t0[0], "out": out,
           "errors": errors}, sys.stdout)
"""


def run_clients(port: int, path: str, bodies, clients: int, n: int,
                rate: float = 0.0, seed: int = 0):
    """`clients` HTTP clients, a thread and a keep-alive connection each in
    one child process, send `n` POSTs to `path` between them: request j
    carries bodies[j % len(bodies)]. At `rate` 0 the loop is closed (a
    client sends its next request when its last one is answered); else
    request j is sent at its Poisson arrival time (`rate` a second, gaps
    from `seed`) by the first free client. Returns (requests a second,
    [(status, payload, ms)] by request)."""
    proc = subprocess.run(
        [sys.executable, "-c", _CLIENTS, str(port), path, str(clients),
         str(n), repr(float(rate)), str(seed)], input=json.dumps([json.dumps(b) for b in bodies]),
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"{path}: clients exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    res = json.loads(proc.stdout)
    if res["errors"] or any(o is None for o in res["out"]):
        raise AssertionError(f"{path}: client errors {res['errors'][:3]}")
    return n / res["wall"], [(status, json.loads(text), ms)
                             for status, text, ms in res["out"]]


class BatchSizes:
    """The size of every batch a dispatch stage is given: wraps the
    attribute `attr` of `obj` (whose positional argument `arg` is the
    batch) until `close`."""

    def __init__(self, obj, attr: str, arg: int):
        self.sizes = []
        self._obj, self._attr = obj, attr
        self._orig = fn = getattr(obj, attr)

        def run(*a, **kw):
            self.sizes.append(len(a[arg]))
            return fn(*a, **kw)

        setattr(obj, attr, run)

    def close(self):
        setattr(self._obj, self._attr, self._orig)


def against_batch1(label, got_ids, got_scores, want_ids, want_scores,
                   tol: float) -> int:
    """0 when a response equals its query's batch-1 answer, 1 when it
    differs only among hits whose scores tie within `tol` (the order of
    tied hits, or which of the hits tied at rank k made the cut); raises
    otherwise. Scores are compared rank by rank."""
    if len(got_ids) != len(want_ids) or any(
            abs(a - b) > tol for a, b in zip(got_scores, want_scores)):
        raise AssertionError(f"{label}: scores {got_scores} against batch "
                             f"1's {want_scores} (tolerance {tol})")
    if got_ids == want_ids:
        return 0
    k = len(want_ids)
    for p, (g, w) in enumerate(zip(got_ids, want_ids)):
        if g != w and p != k - 1 and not any(
                abs(want_scores[q] - want_scores[p]) <= tol
                for q in range(k) if q != p):
            raise AssertionError(f"{label}: hit {p} is {g}, batch 1 had {w} "
                                 f"with no tied score ({want_scores})")
    return 1


def knn_against_batch1(label: str, extra: dict, tol):
    """check(query, payload) of a kNN response against the sequential
    phase's answer to that query; `tol(scores)` is the score tolerance."""
    def check(qi, payload):
        hits = payload["hits"]["hits"]
        want = extra["scores"][qi]
        return against_batch1(f"{label} query {qi}",
                              [int(h["_id"]) for h in hits],
                              [h["_score"] for h in hits],
                              extra["hits"][qi], want, tol(want))
    return check


def serve_concurrent(index: str, port: int, path: str, bodies, levels,
                     n: int, check, sched, sizes, variants,
                     truth=None, recall=None, coalesce_at=None,
                     open_loop=(), histograms_at=None) -> dict:
    """Levels of HTTP clients against one served index: for each C in
    `levels`, C closed-loop clients send `n` requests (`run_clients`);
    then for each fraction f in `open_loop`, `n` requests arrive open-loop
    (Poisson, from the seed) at f times the QPS of the last closed level,
    sent by up to OPEN_LOOP_CLIENTS connections. Every response
    must be a 200 that passes `check(query, payload)` (which returns 1 for
    a response that differs from batch 1 only among tied scores), every
    launch must be one of `variants` (kernel/variant names), recall@10
    against `truth` must not fall below `recall`, and at C >= coalesce_at
    the largest batch must exceed 1. `sched()` reads the batcher's
    counters and `sizes` = (object, attribute, argument) names the
    dispatch stage whose batches are measured. At the closed level of
    `histograms_at` clients the telemetry histograms are reset before the
    level and held to the batcher's counters after it
    (`telemetry_histograms`). Logs a line a level and returns the launches
    of all levels by kernel."""
    from elasticsearch_tpu_torch.ops import dispatch
    total, closed_qps = {}, 0.0
    runs = [(clients, 0.0) for clients in levels] + [
        (OPEN_LOOP_CLIENTS, f) for f in open_loop]
    for clients, frac in runs:
        rate = frac * closed_qps
        batch_sizes = BatchSizes(*sizes)
        histograms = not rate and clients == histograms_at
        if histograms:
            from elasticsearch_tpu_torch import telemetry
            telemetry.REGISTRY.reset()
        before = sched()
        dispatch.reset_launches()
        try:
            qps, out = run_clients(port, path, bodies, clients, n, rate,
                                   seed=len(bodies) + clients)
        finally:
            batch_sizes.close()
        if not rate:
            closed_qps = qps
        launches = {k: c for k, c in dispatch.launches().items() if c}
        by_variant = {k: c for k, c in dispatch.variant_launches().items()
                      if c}
        after = sched()
        label = (f"serve_concurrent {index} "
                 + (f"open {rate:.1f}/s" if rate else f"C={clients}"))
        refused = sum(1 for status, _, _ in out if status == 429)
        failed = [(j, o[0], o[1]) for j, o in enumerate(out) if o[0] != 200]
        if failed:
            raise AssertionError(f"{label}: {len(failed)} requests failed "
                                 f"({refused} 429s); first {failed[0]}")
        if set(by_variant) - set(variants):
            raise AssertionError(f"{label}: launches {by_variant}, "
                                 f"expected only {sorted(variants)}")
        ties = sum(check(j % len(bodies), payload)
                   for j, (_, payload, _) in enumerate(out))
        ms = np.array([o[2] for o in out])
        delta = {key: after[key] - before.get(key, 0) for key in after}
        count = {f"sched_{key}": delta[key]
                 for key in ("batches", "requests", "topups",
                             "pipelined_batches", "overlap_hits")}
        # the batcher's stages: queue wait a request, dispatch (under the
        # run lock) and finalize a batch, host clock
        per = max(delta["batches"], 1)
        count.update(
            queue_wait_ms=f"{delta['queue_wait_nanos'] / max(n, 1) / 1e6:.3f}",
            dispatch_ms_per_batch=f"{delta['dispatch_nanos'] / per / 1e6:.3f}",
            finalize_ms_per_batch=f"{delta['finalize_nanos'] / per / 1e6:.3f}")
        fields = dict(
            index=index, clients=clients, requests=n,
            loop="open" if rate else "closed", arrival_rate=f"{rate:.1f}",
            qps=f"{qps:.1f}",
            p50_ms=f"{np.percentile(ms, 50):.3f}",
            p99_ms=f"{np.percentile(ms, 99):.3f}", **count,
            mean_batch=f"{len(batch_sizes.sizes) and np.mean(batch_sizes.sizes):.2f}",
            max_batch=max(batch_sizes.sizes),
            launches_per_request=json.dumps(
                {k: round(c / n, 4) for k, c in launches.items()}),
            variants_per_request=json.dumps(
                {k: round(c / n, 4) for k, c in by_variant.items()}),
            rejected_429=refused, ties=ties)
        if truth is not None:
            got = float(np.mean([
                len({int(h["_id"]) for h in payload["hits"]["hits"]}
                    & set(truth[j % len(bodies)].tolist())) / 10
                for j, (_, payload, _) in enumerate(out)]))
            fields["recall_at_10"] = got
            if got < recall:
                raise AssertionError(f"{label}: recall@10 {got} < the "
                                     f"sequential {recall}")
        log("serve_concurrent", **fields)
        if histograms:
            telemetry_histograms(port, f"{index} C={clients}", n, delta)
        if coalesce_at is not None and not rate and clients >= coalesce_at \
                and max(batch_sizes.sizes) <= 1:
            raise AssertionError(f"{label}: no batch above 1 request: the "
                                 f"batcher did not coalesce")
        for k, c in launches.items():
            total[k] = total.get(k, 0) + c
    return total


def store_concurrent(name: str, port: int, svc, queries, extra: dict,
                     recall: float, tol, variants,
                     histograms_at=None) -> dict:
    """serve_concurrent over a one-shard kNN index `svc` at C = 1, 8 and
    32, then open loop at 0.5 and 0.9 of the C = 32 level's QPS: the
    index's batcher counters, the batches its shard store dispatches."""
    return serve_concurrent(
        name, port, f"/{name}/_search",
        [knn_body("vec", qv) for qv in queries], (1, 8, 32),
        CONCURRENT_REQUESTS, knn_against_batch1(name, extra, tol),
        svc.vector_store.scheduler_stats, (svc.store, "_dispatch_many", 3),
        variants,
        truth=extra["truth"], recall=recall, coalesce_at=32,
        open_loop=(0.5, 0.9), histograms_at=histograms_at)


def phase_serve(seed: int, n_sift: int, n_cohere: int,
                device: str = "cuda", docs_only: bool = False) -> dict:
    """serve_sift, its concurrent levels, serve_documents on the sift
    index, then the dot index and serve_cohere; `docs_only` runs sift's
    sequential requests and serve_documents alone."""
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    from elasticsearch_tpu_torch.server import build_server
    node, server = build_server(device=device, port=0,
                                settings=SERVE_SETTINGS)
    server.start()
    total = {kb.KERNEL_BF16: 0, kb.KERNEL_INT8: 0}
    try:
        client = Client(server.port)
        rng = np.random.default_rng(seed)

        vecs = clustered(rng, n_sift, 128)
        queries = vecs[rng.integers(0, n_sift, 64)] \
            + 0.3 * rng.standard_normal((64, 128)).astype(np.float32)
        recall, p50, store_p50, ingest, launches, extra = serve_index(
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
        # concurrent clients: scores to the binned kernel's check, one
        # packing quantum of the raw score (half of it in `_score`, which
        # is (1 + cosine) / 2)
        if not docs_only:
            conc = store_concurrent(
                "sift", server.port, node.index("sift"), queries, extra,
                recall, lambda _: BF16_QUANTUM / 2,
                {f"{kb.KERNEL_BF16}/{kb.VARIANT_TMA}"}, histograms_at=8)
            total[kb.KERNEL_BF16] += conc.get(kb.KERNEL_BF16, 0)
            telemetry_cancel(client, node, "sift", queries[0])
        del extra
        # its own generator, so the later indices' data stay the seed's
        for key, c in timed(
                "serve_documents", serve_documents, client, node, vecs,
                queries, np.random.default_rng(seed + 16)).items():
            total[key] += c
        del vecs
        if docs_only:
            return total

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
        for key, c in telemetry_profile(
                client, "cohere", knn_body("vec", cq[0]), "knn.binned",
                kb.KERNEL_INT8).items():
            total[key] += c
        log("serve_cohere", docs=n_cohere, dims=768, requests=len(cq),
            ingest_s=f"{ingest:.2f}", p50_ms=f"{p50:.3f}",
            store_p50_ms=f"{store_p50:.3f}",
            recall_at_10=recall, launches=json.dumps(launches))
    finally:
        server.stop()
    return total


N_DOC_BULK = 10_000         # serve_documents: `_bulk` deletes and updates
N_DOC_SINGLE = 500          # single deletes, updates and auto-id writes
N_SIFT_B = 65_536           # the second index of the expression searches
SIFT_B_REFRESHES = 12       # sift_b's small refreshes (L0 seals) ...
SIFT_B_DOCS = 100           # ... of this many docs each


def _corpus_bytes(node, name: str) -> int:
    """Bytes of the device tensors of every generation of every shard's
    `vec` field (each tensor once)."""
    seen, total = set(), 0
    for shard in node.index(name).shards:
        store = shard.vector_store
        gc = store._gens.get("vec")
        corpora = ([g.corpus for g in gc.snapshot().generations]
                   if gc is not None else [store.field("vec").corpus])
        for corpus in corpora:
            for t in vars(corpus).values():
                if isinstance(t, torch.Tensor) and t.data_ptr() not in seen:
                    seen.add(t.data_ptr())
                    total += t.nbytes
    return total


def _leg_counts(svc, stats0: dict) -> tuple:
    """(exact-route legs, kernel-route legs) of one index's store since
    `stats0`, and its generations holding rows."""
    st = svc.store.knn_stats
    snap = svc.store.field("vec").snap
    return (st["segment_legs_exact"] - stats0["segment_legs_exact"],
            st["segment_legs_auto"] - stats0["segment_legs_auto"],
            sum(1 for g in snap.generations if g.n_rows), snap.simple)


def _served_routes(svc, n_req: int, launches: dict, stats0: dict,
                   binned: int, exact: int) -> dict:
    """Check the kNN route of `n_req` requests on one index: `binned`
    launches of the bf16 binned kernel and `exact` exact-route legs a
    request, as the caller knows the index's generation set (one clean
    generation: 1 and 0; a tombstoned base and a seal: 0 and 2), and no
    kernel-route leg of a larger set. Returns {"binned": launches,
    "exact_legs": legs}."""
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    got = _leg_counts(svc, stats0)[:2] + (launches.get(kb.KERNEL_BF16, 0),)
    if got != (n_req * exact, 0, n_req * binned):
        raise AssertionError(f"{svc.name}: (exact legs, kernel legs, binned "
                             f"launches) {got} for {n_req} requests; "
                             f"expected {binned} launches and {exact} "
                             f"exact legs a request")
    return {"binned": got[2], "exact_legs": got[0]}


def _doc_writes(client, rng, n: int):
    """serve_documents' writes over HTTP on sift: `_bulk` deletes and
    `doc` updates of new vectors, single deletes, updates and auto-id
    writes, and the two 409s. Returns (deleted ids, {id: new vector},
    {auto id: vector})."""
    ids = rng.permutation(n)
    bulk_del = ids[:N_DOC_BULK]
    bulk_upd = ids[N_DOC_BULK:2 * N_DOC_BULK]
    one_del = ids[2 * N_DOC_BULK:2 * N_DOC_BULK + N_DOC_SINGLE]
    one_upd = ids[2 * N_DOC_BULK + N_DOC_SINGLE:
                  2 * N_DOC_BULK + 2 * N_DOC_SINGLE]
    fresh = clustered(rng, len(bulk_upd) + 2 * N_DOC_SINGLE, 128)
    updated = {}
    resp = client.ok("POST", "/sift/_bulk",
                     [{"delete": {"_id": str(i)}} for i in bulk_del],
                     ndjson=True)
    if resp["errors"] or any(it["delete"]["result"] != "deleted"
                             for it in resp["items"]):
        raise AssertionError(f"bulk delete: {resp['items'][:3]}")
    ops = []
    for j, i in enumerate(bulk_upd):
        ops += [{"update": {"_id": str(i)}},
                {"doc": {"vec": fresh[j].tolist()}}]
        updated[str(i)] = fresh[j]
    resp = client.ok("POST", "/sift/_bulk", ops, ndjson=True)
    if resp["errors"] or any(it["update"]["result"] != "updated"
                             for it in resp["items"]):
        raise AssertionError(f"bulk update: {resp['items'][:3]}")
    for i in one_del:
        if client.ok("DELETE", f"/sift/_doc/{i}")["result"] != "deleted":
            raise AssertionError(f"DELETE /sift/_doc/{i}")
    base = len(bulk_upd)
    for j, i in enumerate(one_upd):
        v = fresh[base + j]
        if client.ok("POST", f"/sift/_update/{i}", {
                "doc": {"vec": v.tolist()}})["result"] != "updated":
            raise AssertionError(f"POST /sift/_update/{i}")
        updated[str(i)] = v
    created = {}
    for v in fresh[base + N_DOC_SINGLE:]:
        status, body = client.req("POST", "/sift/_doc", {"vec": v.tolist()})
        if status != 201 or body["result"] != "created":
            raise AssertionError(f"POST /sift/_doc -> {status}: {body}")
        created[body["_id"]] = v
    live = str(ids[-1])
    status, body = client.req("PUT", f"/sift/_create/{live}",
                              {"vec": fresh[0].tolist()})
    if status != 409:
        raise AssertionError(f"_create on a live id -> {status}: {body}")
    seq_no = client.ok("GET", f"/sift/_doc/{live}")["_seq_no"]
    status, body = client.req(
        "PUT", f"/sift/_doc/{live}?if_seq_no={seq_no + 1}&if_primary_term=1",
        {"vec": fresh[0].tolist()})
    if status != 409:
        raise AssertionError(f"stale if_seq_no -> {status}: {body}")
    deleted = {str(i) for i in bulk_del} | {str(i) for i in one_del}
    return deleted, updated, created


def _doc_checks(client, node, vecs, queries, deleted, updated, created):
    """The gates after the refresh: recall@10 of the 64 queries against
    exact f32 numpy over the live documents, no deleted id in a hit, each
    of 64 updated documents first for its new vector, `_count` exact,
    `_mget` of deleted and updated ids, and the batch-1 answers against
    one batch of the same queries through the index's store (ties
    counted); the served route of its two generations, no binned launch
    and two exact legs a request (`_served_routes`). Returns (recall, p50 ms, the routes of the served
    requests, ties)."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    from elasticsearch_tpu_torch.ops import similarity as sim
    names = [str(i) for i in range(len(vecs))] + list(created)
    live = np.concatenate([vecs, np.stack(list(created.values()))])
    for key, v in updated.items():
        live[int(key)] = v
    keep = np.array([nm not in deleted for nm in names])
    live_names = [nm for nm, k in zip(names, keep) if k]
    truth = exact_top(live[keep], queries, 10, "cosine")
    svc = node.index("sift")
    stats0 = dict(svc.store.knn_stats)
    dispatch.reset_launches()
    lat, got, got_scores = [], [], []
    for qv in queries:
        t = time.perf_counter()
        resp = client.ok("POST", "/sift/_search", knn_body("vec", qv))
        lat.append((time.perf_counter() - t) * 1e3)
        got.append([h["_id"] for h in resp["hits"]["hits"]])
        got_scores.append([h["_score"] for h in resp["hits"]["hits"]])
    upd_keys = list(updated)[:64]
    for key in upd_keys:
        hits = client.ok("POST", "/sift/_search", knn_body(
            "vec", updated[key]))["hits"]["hits"]
        if hits[0]["_id"] != key:
            raise AssertionError(f"updated doc {key}: first hit "
                                 f"{hits[0]['_id']}")
        if deleted & {h["_id"] for h in hits}:
            raise AssertionError(f"deleted ids in {key}'s hits")
    launches = dispatch.launches()
    n_req = len(queries) + len(upd_keys)
    # the tombstoned base and the seal, each on the exact route
    routes = _served_routes(svc, n_req, launches, stats0, binned=0, exact=2)
    _expect_served_variant(kb.KERNEL_BF16 if routes["binned"] else None,
                           dispatch.variant_launches(), n_req)
    if {k for k, c in launches.items() if c} - {kb.KERNEL_BF16}:
        raise AssertionError(f"launches {launches} for {n_req} requests")
    if any(deleted & set(g) for g in got):
        raise AssertionError("a deleted id in a hit")
    recall = float(np.mean([
        len(set(g) & {live_names[r] for r in t.tolist()}) / 10
        for g, t in zip(got, truth)]))
    count = client.ok("POST", "/sift/_count")["count"]
    if count != int(keep.sum()):
        raise AssertionError(f"_count {count}, live {int(keep.sum())}")
    probe = sorted(deleted)[:32] + upd_keys[:32]
    docs = client.ok("POST", "/sift/_mget", {"ids": probe})["docs"]
    for key, doc in zip(probe, docs):
        if key in deleted:
            if doc["found"]:
                raise AssertionError(f"_mget: deleted {key} found")
        elif not doc["found"] or not np.array_equal(
                np.asarray(doc["_source"]["vec"], dtype=np.float32),
                updated[key]):
            raise AssertionError(f"_mget: updated {key} is {doc}")
    # the same queries as one batch through the index's store
    batch = svc.vector_store.search_many("vec", list(queries), 10)
    reader = svc.combined_reader()
    ties = 0
    for qi, (rows, raw) in enumerate(batch):
        want = np.asarray(sim.to_es_score(raw, "cosine")).tolist()
        ties += against_batch1(
            f"serve_documents query {qi}", got[qi], got_scores[qi],
            [reader.get_id(int(r)) for r in rows], want, BF16_QUANTUM / 2)
    # the routes of the served requests, read before the batch check
    return recall, statistics.median(lat), routes, ties


def _merge_plan(policy, base_rows: int, seals: int, rows: int) -> tuple:
    """The merges `policy` selects when `seals` generations of `rows` rows
    seal one at a time after a base of `base_rows`, every pending merge
    run after each seal: (reasons by count, the final tiers)."""
    from elasticsearch_tpu_torch.segments.generation import generation_tier
    gens, reasons = [(generation_tier(base_rows), base_rows)], {}

    class G:                      # what the policy reads of a generation
        def __init__(self, n):
            self.tier, self.n_rows, self.dead_rows = \
                generation_tier(n), n, 0

    for _ in range(seals):
        gens.append((generation_tier(rows), rows))
        while True:
            spec = policy.select([G(n) for _, n in gens])
            if spec is None:
                break
            reasons[spec.reason] = reasons.get(spec.reason, 0) + 1
            merged = sum(n for _, n in gens[spec.start:spec.stop])
            gens[spec.start:spec.stop] = [(generation_tier(merged), merged)]
    return reasons, [t for t, _ in gens]


def _sift_b_generations(client, node, rng, bvecs) -> tuple:
    """sift_b's write-while-search part: SIFT_B_REFRESHES refreshes of
    SIFT_B_DOCS docs each seal L0 generations and start background merges,
    whose reasons must be the policy's choice on the same sequence;
    after `drain()` at most `max_l0` L0 generations and recall@10 >=
    0.95; then `POST /sift_b/_forcemerge`: the store rebuilds the re-based
    rows (`segment_rewrite`) into one clean generation. Returns (the new
    docs' vectors, the fields to log)."""
    svc = node.index("sift_b")
    store = svc.store
    gc = store._gens["vec"]
    extra = clustered(rng, SIFT_B_REFRESHES * SIFT_B_DOCS, 128)
    st0 = store.segment_stats()
    refresh_s = []
    for r in range(SIFT_B_REFRESHES):
        lo = r * SIFT_B_DOCS
        svc.index_many([f"b{N_SIFT_B + lo + j}" for j in range(SIFT_B_DOCS)],
                       vectors={"vec": extra[lo:lo + SIFT_B_DOCS]})
        t = time.perf_counter()
        client.ok("POST", "/sift_b/_refresh")
        refresh_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    gc.drain()
    drain_s = time.perf_counter() - t
    st = store.segment_stats()
    want, tiers = _merge_plan(gc.policy, N_SIFT_B, SIFT_B_REFRESHES,
                              SIFT_B_DOCS)
    got_tiers = [g.tier for g in gc.snapshot().generations]
    if (st["merge_reasons"] != want or got_tiers != tiers
            or st["l0_generations"] > store.segments_max_l0
            or st["seals"] - st0["seals"] != SIFT_B_REFRESHES
            or st["full_rebuilds"] != st0["full_rebuilds"]):
        raise AssertionError(f"sift_b merges {st}, tiers {got_tiers}; "
                             f"expected {want}, tiers {tiers}")
    bvecs = np.concatenate([bvecs, extra])
    qs = bvecs[rng.integers(0, len(bvecs), 32)] \
        + 0.3 * rng.standard_normal((32, 128)).astype(np.float32)
    truth = exact_top(bvecs, qs, 10, "cosine")
    names = [f"b{i}" for i in range(len(bvecs))]

    def recall():
        got = [{h["_id"] for h in client.ok("POST", "/sift_b/_search",
                                            knn_body("vec", qv))
                ["hits"]["hits"]} for qv in qs]
        return float(np.mean([len(g & {names[r] for r in t.tolist()}) / 10
                              for g, t in zip(got, truth)]))

    merged_recall = recall()
    t = time.perf_counter()
    client.ok("POST", "/sift_b/_forcemerge")
    forcemerge_s = time.perf_counter() - t
    st2 = store.segment_stats()
    reasons = dict(st0["rebuild_reasons"])
    reasons["segment_rewrite"] = reasons.get("segment_rewrite", 0) + 1
    if (st2["rebuild_reasons"] != reasons or st2["generations"] != 1
            or not store.field("vec").snap.simple):
        raise AssertionError(f"sift_b after _forcemerge: {st2}")
    forced_recall = recall()
    if min(merged_recall, forced_recall) < 0.95:
        raise AssertionError(f"sift_b recall@10 {merged_recall} merged, "
                             f"{forced_recall} after _forcemerge")
    return extra, dict(
        sift_b_refreshes=SIFT_B_REFRESHES, docs_each=SIFT_B_DOCS,
        refresh_p50_s=f"{statistics.median(refresh_s):.4f}",
        merges=st["merges"] - st0["merges"],
        merge_reasons=json.dumps(st["merge_reasons"]),
        merge_s=f"{(st['merge_nanos'] - st0['merge_nanos']) / 1e9:.3f}",
        drain_s=f"{drain_s:.3f}", generations=st["generations"],
        l0_generations=st["l0_generations"],
        recall_at_10=merged_recall, forcemerge_s=f"{forcemerge_s:.3f}",
        forced_recall_at_10=forced_recall)


def _union_checks(client, node, rng, queries, live_of):
    """sift_b (65,536 x 128, the same mapping), its generations and
    `_forcemerge` (`_sift_b_generations`); then `sift,sift_b`, `sift*` and
    no index give recall@10 against the exact top over the union, each
    hit's `_index` right and `_shards.total` 2, sift on its two exact legs
    and sift_b, merged, on one binned launch a request; `_msearch` of 16 lines
    equals the 16 single searches; then the `[search_api]` part on both
    (`search_api_sift`). Returns (recall, bf16 launches, the exact legs,
    the sift_b fields to log)."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    bvecs = clustered(rng, N_SIFT_B, 128)
    client.ok("PUT", "/sift_b", {"settings": {"number_of_shards": 1},
                                 "mappings": {"properties": {"vec": {
                                     "type": "dense_vector", "dims": 128,
                                     "similarity": "cosine"}}}})
    node.index("sift_b").index_many([f"b{i}" for i in range(N_SIFT_B)],
                                    vectors={"vec": bvecs})
    client.ok("POST", "/sift_b/_refresh")
    extra, b_fields = _sift_b_generations(client, node, rng, bvecs)
    bvecs = np.concatenate([bvecs, extra])
    names, live = live_of()
    union_names = names + [f"b{i}" for i in range(len(bvecs))]
    qs = np.concatenate([
        queries[:32], bvecs[rng.integers(0, len(bvecs), 32)]
        + 0.3 * rng.standard_normal((32, 128)).astype(np.float32)])
    truth = exact_top(np.concatenate([live, bvecs]), qs, 10, "cosine")
    svcs = [node.index("sift"), node.index("sift_b")]
    stats0 = [dict(svc.store.knn_stats) for svc in svcs]
    dispatch.reset_launches()
    recalls, singles = [], []
    for path in ("/sift,sift_b/_search", "/sift*/_search", "/_search"):
        for qi, qv in enumerate(qs):
            resp = client.ok("POST", path, knn_body("vec", qv))
            if resp["_shards"]["total"] != 2:
                raise AssertionError(f"{path}: _shards {resp['_shards']}")
            hits = resp["hits"]["hits"]
            for h in hits:
                if h["_index"] != ("sift_b" if h["_id"][0] == "b"
                                   else "sift"):
                    raise AssertionError(f"{path}: hit {h}")
            recalls.append(len({h["_id"] for h in hits} & {
                union_names[r] for r in truth[qi].tolist()}) / 10)
            if path == "/sift,sift_b/_search" and qi % 4 == 0:
                singles.append((qv, resp))
    lines = []
    for qv, _ in singles:
        lines += [{"index": "sift,sift_b"}, knn_body("vec", qv)]
    multi = client.ok("POST", "/_msearch", lines, ndjson=True)["responses"]
    for (_, one), many in zip(singles, multi):
        if many["status"] != 200 or many["hits"] != one["hits"]:
            raise AssertionError(f"_msearch entry {many} against {one}")
    launches = dispatch.launches().get(kb.KERNEL_BF16, 0)
    n_req = 3 * len(qs) + len(singles)
    # sift: its tombstoned base and its seal on the exact route; sift_b
    # after `_forcemerge`: one clean generation, one binned launch
    counts = [_leg_counts(svc, st) for svc, st in zip(svcs, stats0)]
    if launches != n_req or counts != [(2 * n_req, 0, 2, False),
                                       (0, 0, 1, True)]:
        raise AssertionError(f"union: {launches} launches for {n_req} "
                             f"requests over 2 indices, legs (exact, "
                             f"kernel, generations, clean) {counts}")
    t = time.perf_counter()
    launches += search_api_sift(client, node, names, live, bvecs, qs[::4])
    log("timing", step="search_api_sift",
        seconds=f"{time.perf_counter() - t:.1f}")
    return (float(np.mean(recalls)), launches, counts[0][0], b_fields)


def serve_documents(client, node, vecs, queries, rng) -> dict:
    """The document and index API on sift at full width: writes, a timed
    refresh (the generational path: tombstones and an L0 seal), the gates
    after it, sift_b's generations and `_forcemerge`, the expression
    searches over sift and sift_b, the `[node_apis]` part on sift
    (`node_apis_sift`), and the indices deleted through `DELETE /{index}`
    with every generation's device memory freed. Returns the binned
    kernels' launches by kernel."""
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    t0 = time.perf_counter()
    deleted, updated, created = _doc_writes(client, rng, len(vecs))
    store = node.index("sift").store
    st0 = store.segment_stats()
    t = time.perf_counter()
    client.ok("POST", "/sift/_refresh")
    refresh_s = time.perf_counter() - t
    st = store.segment_stats()
    gone = len(deleted) + len(updated)
    sealed = len(updated) + len(created)
    if (st["full_rebuilds"] != st0["full_rebuilds"]
            or st["rebuilds_avoided"] != st0["rebuilds_avoided"] + 1
            or st["generations"] != 2 or st["tombstoned_rows"] != gone
            or st["sealed_rows"] - st0.get("sealed_rows", 0) != sealed):
        raise AssertionError(f"sift refresh after the writes: {st}, "
                             f"before {st0}")
    recall, p50, routes, ties = _doc_checks(
        client, node, vecs, queries, deleted, updated, created)
    if recall < 0.95:
        raise AssertionError(f"serve_documents recall@10 {recall} < 0.95")
    log("segments", index="sift", refresh_s=f"{refresh_s:.3f}",
        generations=st["generations"], l0_generations=st["l0_generations"],
        tombstoned_rows=st["tombstoned_rows"],
        seals=st["seals"] - st0.get("seals", 0), sealed_rows=sealed,
        rebuilds_avoided=st["rebuilds_avoided"] - st0["rebuilds_avoided"],
        full_rebuilds=st["full_rebuilds"] - st0["full_rebuilds"],
        recall_at_10=recall, p50_ms=f"{p50:.3f}",
        binned_launches=routes["binned"], exact_legs=routes["exact_legs"],
        bytes_mb=f"{st['bytes'] / 2**20:.1f}")

    def live_of():
        names = [str(i) for i in range(len(vecs))] + list(created)
        live = np.concatenate([vecs, np.stack(list(created.values()))])
        for key, v in updated.items():
            live[int(key)] = v
        keep = np.array([nm not in deleted for nm in names])
        return [nm for nm, k in zip(names, keep) if k], live[keep]

    union, union_launches, union_legs, b_fields = _union_checks(
        client, node, rng, queries, live_of)
    log("segments", index="sift_b", **b_fields)
    if union < 0.95:
        raise AssertionError(f"union recall@10 {union} < 0.95")
    union_launches += telemetry_sift_b(client, node, rng)
    t = time.perf_counter()
    union_launches += dsl_sift(client, node, rng, queries, deleted, updated,
                               live_of)
    log("timing", step="dsl_sift", seconds=f"{time.perf_counter() - t:.1f}")
    t = time.perf_counter()
    node_launches = node_apis_sift(client, node, queries, rng, live_of)
    log("timing", step="node_apis_sift",
        seconds=f"{time.perf_counter() - t:.1f}")
    union_launches += node_launches.pop(kb.KERNEL_BF16, 0)
    client.ok("DELETE", "/sift_r")
    gc.collect()
    torch.cuda.synchronize()
    corpora = _corpus_bytes(node, "sift") + _corpus_bytes(node, "sift_b")
    before = torch.cuda.memory_allocated()
    for name in ("sift_b", "sift"):
        client.ok("DELETE", f"/{name}")
    gc.collect()
    freed = before - torch.cuda.memory_allocated()
    if freed < 0.9 * corpora:
        raise AssertionError(f"DELETE freed {freed} bytes of the corpora's "
                             f"{corpora}")
    status, _ = client.req("POST", "/sift/_search", knn_body("vec",
                                                            queries[0]))
    if status != 404:
        raise AssertionError(f"search of a deleted index -> {status}")
    launches = routes["binned"] + union_launches
    log("serve_documents", deleted=len(deleted), updated=len(updated),
        created=len(created), refresh_s=f"{refresh_s:.3f}",
        recall_at_10=recall, p50_ms=f"{p50:.3f}", ties=ties,
        union_recall_at_10=union, freed_mb=f"{freed / 2**20:.1f}",
        corpora_mb=f"{corpora / 2**20:.1f}", launches=launches,
        exact_legs=routes["exact_legs"] + union_legs,
        seconds=f"{time.perf_counter() - t0:.1f}")
    return {kb.KERNEL_BF16: launches, **node_launches}


N_NODE_DBQ = 10_000         # [node_apis]: sift documents deleted by query
N_NODE_UBQ = 10_000         # ... and updated by query
N_NODE_REINDEX = 100_000    # ... reindexed into sift_r (2 shards, int8)
NODE_API_REQUESTS = 16      # the requests behind each host API's p50


def _ids_recall(got, truth) -> float:
    """recall@10 of hit ids against the exact top-10 ids, each id counted
    as often as it appears (a union of indices holds some ids twice)."""
    from collections import Counter
    return float(np.mean([sum((Counter(g) & Counter(t)).values()) / 10
                          for g, t in zip(got, truth)]))


def _knn_ids(client, path: str, queries, expect=None) -> tuple:
    """The hit ids (and `_index`, `_id` pairs) of one `knn` request a
    query, with the launches they made (counts reset just before)."""
    from elasticsearch_tpu_torch.ops import dispatch
    dispatch.reset_launches()
    ids, pairs = [], []
    for qv in queries:
        hits = client.ok("POST", path, knn_body("vec", qv))["hits"]["hits"]
        if len(hits) != 10 or not all(np.isfinite(h["_score"])
                                      for h in hits):
            raise AssertionError(f"{path}: bad hits {hits}")
        ids.append([h["_id"] for h in hits])
        pairs.append([(h["_index"], h["_id"], h["_score"]) for h in hits])
    launches = {k: c for k, c in dispatch.launches().items() if c}
    if expect is not None and launches != expect:
        raise AssertionError(f"{path}: launches {launches}, expected "
                             f"{expect}")
    return ids, pairs, launches


def node_apis_sift(client, node, queries, rng, live_of) -> dict:
    """The `[node_apis]` part on sift (1M x 128 cosine `flat`, after
    serve_documents' writes): `_delete_by_query` of N_NODE_DBQ ids and
    `_update_by_query` of N_NODE_UBQ others (a script sets `tag`), each
    ending in one refresh on the generational path (no full rebuild),
    then recall@10 >= 0.95 of 64 `knn` queries against exact f32 numpy
    over the live rows (the tombstoned generations take the
    `segments.knn` exact legs); `_reindex` of N_NODE_REINDEX documents
    into sift_r (2 shards, `int8_flat` + rescore: `knn_binned_int8`, 2
    launches a request, recall >= 0.95 over the ids it holds); aliases
    (one index: the same hits and documents as sift; sift and sift_r:
    union recall >= 0.95, a document operation the reference's 400);
    sift_r closed (a `knn` is a 400 that launches nothing, `_cat/indices`
    says `close`) and opened (the same hits, the same device memory);
    then on sift_b (one clean generation after serve_documents'
    `_forcemerge`, so on the binned kernel) `_async_search` of a `knn`
    body polled to its end (the synchronous hits, one `knn_binned_bf16`
    launch) and `_explain` of the top hit with a `knn` clause (its
    exact-route value within BF16_QUANTUM / 2 of the hit's `_score`).
    Returns the binned launches by kernel."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    card = repr(nvidia_smi_line())
    t_part = time.perf_counter()
    store = node.index("sift").store
    out = {kb.KERNEL_BF16: 0, kb.KERNEL_INT8: 0}
    names, live = live_of()
    pick = rng.permutation(len(names))[:N_NODE_DBQ + N_NODE_UBQ]
    dbq_ids = [names[i] for i in pick[:N_NODE_DBQ]]
    ubq_ids = [names[i] for i in pick[N_NODE_DBQ:]]
    gone = set(dbq_ids)
    keep = np.ones(len(names), dtype=bool)
    keep[pick[:N_NODE_DBQ]] = False
    names = [nm for nm, k in zip(names, keep) if k]
    live = live[keep]
    at = {nm: i for i, nm in enumerate(names)}
    # the live rows after the delete; the update keeps every vector
    truth = [[names[r] for r in t.tolist()]
             for t in exact_top(live, queries, 10, "cosine")]

    def by_query(label, path, body, key, n):
        """One by-query request, its refresh timed (the index's `refresh`
        wrapped for the request), then the `knn` checks."""
        svc = node.index("sift")
        count0 = client.ok("POST", "/sift/_count")["count"]
        st0 = store.segment_stats()
        box, inner = {}, svc.refresh

        def refresh():
            t = time.perf_counter()
            inner()
            box["refresh_s"] = time.perf_counter() - t
        svc.refresh = refresh
        t = time.perf_counter()
        try:
            resp = client.ok("POST", path, body)
        finally:
            del svc.refresh
        seconds = time.perf_counter() - t
        st = store.segment_stats()
        if resp[key] != n or resp["failures"]:
            raise AssertionError(f"{label}: {key} {resp[key]} of {n}, "
                                 f"failures {resp['failures'][:3]}")
        if st["full_rebuilds"] != st0["full_rebuilds"]:
            raise AssertionError(f"{label}: a full rebuild, {st0} -> {st}")
        ids, pairs, launches = _knn_ids(client, "/sift/_search", queries)
        if set(launches) - {kb.KERNEL_BF16}:
            raise AssertionError(f"{label}: launches {launches}")
        if any(gone & set(g) for g in ids):
            raise AssertionError(f"{label}: a deleted id in a hit")
        recall = _ids_recall(ids, truth)
        if recall < 0.95:
            raise AssertionError(f"{label} recall@10 {recall} < 0.95")
        count = client.ok("POST", "/sift/_count")["count"]
        log("node_apis", step=label, docs=n, seconds=f"{seconds:.3f}",
            docs_s=f"{n / seconds:.0f}",
            refresh_s=f"{box.get('refresh_s', float('nan')):.3f}",
            count_before=count0, count_after=count,
            rebuilds_avoided=st["rebuilds_avoided"]
            - st0["rebuilds_avoided"],
            full_rebuilds=st["full_rebuilds"] - st0["full_rebuilds"],
            generations=st["generations"],
            tombstoned_rows=st["tombstoned_rows"], recall_at_10=recall,
            launches=json.dumps(launches), card=card)
        out[kb.KERNEL_BF16] += launches.get(kb.KERNEL_BF16, 0)
        return count0, count, pairs

    c0, c1, _ = by_query("delete_by_query", "/sift/_delete_by_query",
                         {"query": {"ids": {"values": dbq_ids}}}, "deleted",
                         N_NODE_DBQ)
    if c0 - c1 != N_NODE_DBQ:
        raise AssertionError(f"_count {c0} -> {c1} after deleting "
                             f"{N_NODE_DBQ}")
    _, _, sift_pairs = by_query(
        "update_by_query", "/sift/_update_by_query",
        {"query": {"ids": {"values": ubq_ids}},
         "script": {"source": "ctx._source.tag = 'node_apis'"}},
        "updated", N_NODE_UBQ)
    tagged = client.ok("POST", "/sift/_count", {"query": {"match": {
        "tag": "node_apis"}}})["count"]
    if tagged != N_NODE_UBQ:
        raise AssertionError(f"match on tag counts {tagged}")

    # _reindex into a 2-shard int8 index
    client.ok("PUT", "/sift_r", {
        "settings": {"number_of_shards": 2},
        "mappings": {"properties": {"vec": {
            "type": "dense_vector", "dims": 128, "similarity": "cosine",
            "index_options": {"type": "int8_flat", "rescore": True}}}}})
    t = time.perf_counter()
    resp = client.ok("POST", "/_reindex", {
        "source": {"index": "sift"}, "dest": {"index": "sift_r"},
        "max_docs": N_NODE_REINDEX})
    reindex_s = time.perf_counter() - t
    if resp["created"] != N_NODE_REINDEX or resp["failures"]:
        raise AssertionError(f"_reindex: created {resp['created']}, "
                             f"failures {resp['failures'][:3]}")
    held = [shard.engine.acquire_searcher()
            for shard in node.index("sift_r").shards]
    r_names = [r.get_id(int(row)) for r in held
               for row in r.live_global_rows()]
    r_live = live[[at[nm] for nm in r_names]]
    r_truth = [[r_names[i] for i in t.tolist()]
               for t in exact_top(r_live, queries, 10, "cosine")]
    r_ids, r_pairs, launches = _knn_ids(
        client, "/sift_r/_search", queries,
        {kb.KERNEL_INT8: 2 * len(queries)})
    out[kb.KERNEL_INT8] += launches[kb.KERNEL_INT8]
    r_recall = _ids_recall(r_ids, r_truth)
    if r_recall < 0.95:
        raise AssertionError(f"sift_r recall@10 {r_recall} < 0.95")
    log("node_apis", step="reindex", docs=N_NODE_REINDEX, shards=2,
        index_options="int8_flat+rescore", seconds=f"{reindex_s:.3f}",
        docs_s=f"{N_NODE_REINDEX / reindex_s:.0f}", recall_at_10=r_recall,
        launches=json.dumps(launches), card=card)

    # aliases
    client.ok("POST", "/_aliases", {"actions": [
        {"add": {"index": "sift", "alias": "sift_one"}},
        {"add": {"indices": ["sift", "sift_r"], "alias": "sift_both"}}]})
    _, one_pairs, launches = _knn_ids(client, "/sift_one/_search", queries)
    out[kb.KERNEL_BF16] += launches.get(kb.KERNEL_BF16, 0)
    if one_pairs != sift_pairs:
        raise AssertionError("sift_one's hits differ from sift's")
    for doc_id in names[:16]:
        a = client.ok("GET", f"/sift_one/_doc/{doc_id}")
        b = client.ok("GET", f"/sift/_doc/{doc_id}")
        if a != b:
            raise AssertionError(f"sift_one/_doc/{doc_id}: {a} != {b}")
    both_ids, _, launches = _knn_ids(client, "/sift_both/_search", queries)
    if launches.get(kb.KERNEL_INT8) != 2 * len(queries):
        raise AssertionError(f"sift_both: launches {launches}")
    for k in out:
        out[k] += launches.get(k, 0)
    union_names = names + r_names
    union_truth = [[union_names[i] for i in t.tolist()] for t in exact_top(
        np.concatenate([live, r_live]), queries, 10, "cosine")]
    union = _ids_recall(both_ids, union_truth)
    if union < 0.95:
        raise AssertionError(f"sift_both union recall@10 {union} < 0.95")
    status, err = client.req("GET", f"/sift_both/_doc/{names[0]}")
    if status != 400 or "more than one indices" not in \
            err["error"]["reason"]:
        raise AssertionError(f"a doc op on sift_both -> {status} {err}")
    log("node_apis", step="aliases", one_same_hits=True,
        union_recall_at_10=union, multi_index_doc_status=status, card=card)

    # close and open sift_r
    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    client.ok("POST", "/sift_r/_close")
    dispatch.reset_launches()
    status, err = client.req("POST", "/sift_r/_search",
                             knn_body("vec", queries[0]))
    closed_launches = sum(dispatch.launches().values())
    if status != 400 or err["error"]["type"] != "index_closed_exception" \
            or closed_launches:
        raise AssertionError(f"knn on closed sift_r -> {status} {err}, "
                             f"{closed_launches} launches")
    cat = client.ok("GET", "/_cat/indices/sift_r?h=status,index&format=json")
    if cat != [{"status": "close", "index": "sift_r"}]:
        raise AssertionError(f"_cat/indices on closed sift_r: {cat}")
    client.ok("POST", "/sift_r/_open")
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    _, o_pairs, launches = _knn_ids(client, "/sift_r/_search", queries,
                                    {kb.KERNEL_INT8: 2 * len(queries)})
    out[kb.KERNEL_INT8] += launches[kb.KERNEL_INT8]
    if o_pairs != r_pairs:
        raise AssertionError("sift_r's hits after _open differ")
    log("node_apis", step="close_open", closed_status=status,
        closed_launches=closed_launches, reopened_same_hits=True,
        memory_allocated_before_close=mem_before,
        memory_allocated_after_open=mem_after, card=card)

    # on sift_b's binned route: _async_search polled to its end, and
    # _explain of the top hit with a knn clause (the exact route's value)
    _, b_pairs, launches = _knn_ids(client, "/sift_b/_search", queries[:2],
                                    {kb.KERNEL_BF16: 2})
    out[kb.KERNEL_BF16] += 2
    dispatch.reset_launches()
    sub = client.ok("POST", "/sift_b/_async_search"
                    "?wait_for_completion_timeout=0s",
                    knn_body("vec", queries[1]))
    polls = 0
    while True:
        got = client.ok("GET", f"/_async_search/{sub['id']}")
        if not got["is_running"]:
            break
        polls += 1
        time.sleep(0.002)
    launches = {k: c for k, c in dispatch.launches().items() if c}
    if "error" in got or launches != {kb.KERNEL_BF16: 1}:
        raise AssertionError(f"_async_search: {got.get('error')}, "
                             f"launches {launches}")
    out[kb.KERNEL_BF16] += 1
    if [(h["_index"], h["_id"], h["_score"]) for h in
            got["response"]["hits"]["hits"]] != b_pairs[1]:
        raise AssertionError("_async_search hits differ from _search's")
    client.ok("DELETE", f"/_async_search/{sub['id']}")
    _, top_id, top_score = b_pairs[0][0]
    ex = client.ok("POST", f"/sift_b/_explain/{top_id}", {"query": {"knn": {
        "field": "vec", "query_vector": queries[0].tolist(), "k": 10,
        "num_candidates": 100}}})
    diff = abs(ex["explanation"]["value"] - top_score)
    if not ex["matched"] or diff > BF16_QUANTUM / 2:
        raise AssertionError(f"_explain {top_id}: {ex['matched']}, "
                             f"|value - _score| {diff}")
    log("node_apis", step="async_explain", index="sift_b",
        async_polls=polls, async_same_hits=True,
        async_launches=json.dumps(launches), explain_matched=True,
        explain_abs_diff=f"{diff:.3g}",
        part_s=f"{time.perf_counter() - t_part:.1f}", card=card)
    client.ok("POST", "/_aliases", {"actions": [
        {"remove": {"index": "sift", "alias": "sift_*"}},
        {"remove": {"index": "sift_r", "alias": "sift_*"}}]})
    return out


def _node_api_p50(client, label, method, path, body=None, check=None):
    """The HTTP p50 (host clock) of NODE_API_REQUESTS requests, each
    answer held to `check`."""
    lat = []
    for _ in range(NODE_API_REQUESTS):
        t = time.perf_counter()
        status, payload = client.req(method, path, body)
        lat.append((time.perf_counter() - t) * 1e3)
        if status != 200 or (check is not None and not check(payload)):
            raise AssertionError(f"{label}: {status} {str(payload)[:300]}")
    return statistics.median(lat)


def node_apis_logs(client, node) -> None:
    """The `[node_apis]` host APIs on serve_logs: `PUT _settings` on
    `index.max_result_window` refuses the next deep page and `null`
    serves it again; then the HTTP p50 of `_field_caps`,
    `_validate/query`, `_termvectors` (`request`), `_analyze`,
    `_search_shards`, `_cluster/health`, `_cat/indices`, `_cat/shards`
    and `GET /_nodes`, each answer checked."""
    card = repr(nvidia_smi_line())
    t0 = time.perf_counter()
    page = {"from": 95, "size": 10, "sort": [{"@timestamp": "asc"}]}
    client.ok("POST", "/logs/_search", page)
    client.ok("PUT", "/logs/_settings", {"index": {
        "max_result_window": 100}})
    status, err = client.req("POST", "/logs/_search", page)
    if status != 400 or "max_result_window" not in err["error"]["reason"]:
        raise AssertionError(f"max_result_window 100: {status} {err}")
    client.ok("PUT", "/logs/_settings", {"index": {
        "max_result_window": None}})
    client.ok("POST", "/logs/_search", page)
    n = node.index("logs").doc_count()
    fields = {}
    fields["field_caps"] = _node_api_p50(
        client, "_field_caps", "GET", "/logs/_field_caps?fields=*",
        check=lambda r: r["fields"]["request"]["text"]["searchable"]
        and r["fields"]["status"]["integer"]["aggregatable"])
    fields["validate"] = _node_api_p50(
        client, "_validate", "POST", "/logs/_validate/query?explain=true",
        {"query": {"bool": {"must": [{"match": {"request": "english"}}],
                            "filter": [{"range": {"status": {
                                "gte": 400}}}]}}},
        check=lambda r: r["valid"] and r["explanations"][0]["valid"])
    fields["termvectors"] = _node_api_p50(
        client, "_termvectors", "GET",
        "/logs/_termvectors/17?fields=request&term_statistics=true",
        check=lambda r: r["found"] and r["term_vectors"]["request"]["terms"])
    fields["analyze"] = _node_api_p50(
        client, "_analyze", "POST", "/logs/_analyze",
        {"field": "request", "text": "GET /english/12/news_37.html HTTP/1.0",
         "analyzer": "standard"},
        check=lambda r: len(r["tokens"]) > 3)
    fields["search_shards"] = _node_api_p50(
        client, "_search_shards", "GET", "/logs/_search_shards",
        check=lambda r: len(r["shards"]) == 1)
    fields["cluster_health"] = _node_api_p50(
        client, "_cluster/health", "GET", "/_cluster/health",
        check=lambda r: r["status"] == "yellow")
    fields["cat_indices"] = _node_api_p50(
        client, "_cat/indices", "GET",
        "/_cat/indices?format=json&h=index,docs.count",
        check=lambda r: {"index": "logs", "docs.count": str(n)} in r)
    fields["cat_shards"] = _node_api_p50(
        client, "_cat/shards", "GET", "/_cat/shards/logs?format=json",
        check=lambda r: r[0]["state"] == "STARTED"
        and r[0]["docs"] == str(n))
    fields["nodes"] = _node_api_p50(
        client, "_nodes", "GET", "/_nodes",
        check=lambda r: node.node_id in r["nodes"])
    log("node_apis", part="logs", lines=n, requests_each=NODE_API_REQUESTS,
        **{f"{k}_p50_ms": f"{v:.3f}" for k, v in fields.items()},
        seconds=f"{time.perf_counter() - t0:.1f}", card=card)


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
    the small index stays exhaustive and the one full refresh trains once),
    then the IVF checks: every timed request took the IVF route (the fused
    route when `kernel` is set) with no fallback, and one
    `store.search_many` of the same queries launches `kernel` once and
    gives the same hits. Returns (recall, the store's field, the HTTP
    requests' hits, scores and exact top-k, the fields to log, the
    launches)."""
    from elasticsearch_tpu_torch.ops import dispatch
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
    store = node.index(name).store
    fc = store.field("vec")
    # the same queries as one batch through the store: the router's real
    # (clustered) probes at Q > 1, the same hits as the requests one by one
    dispatch.reset_launches()
    t0 = time.perf_counter()
    batch = store.search_many("vec", list(queries), 10)   # lands on the host
    batch_ms = (time.perf_counter() - t0) * 1e3
    batch_hits = [[int(r) for r in rows] for rows, _ in batch]
    batch_recall = float(np.mean([len(set(b) & set(t.tolist())) / 10
                                  for b, t in zip(batch_hits,
                                                  extra["truth"])]))
    if [set(b) for b in batch_hits] != [set(h) for h in extra["hits"]] \
            or batch_recall != recall:
        raise AssertionError(f"{name}: the batch of {n} gives other hits "
                             f"than the requests one by one (recall "
                             f"{batch_recall} against {recall})")
    batch_launches = {k: c for k, c in dispatch.launches().items() if c}
    if batch_launches != ({kernel: 1} if kernel else {}):
        raise AssertionError(f"{name}: batch launches {batch_launches}")
    _expect_served_variant(kernel, dispatch.variant_launches(),
                           1 if kernel else 0)
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
                  recall_at_10=recall, launches=json.dumps(launches),
                  batch_queries=n, batch_ms=f"{batch_ms:.3f}",
                  batch_recall_at_10=batch_recall,
                  batch_variants=json.dumps(dispatch.variant_launches()))
    # the router's phase times (after a device sync each), mean per request
    for phase in ("route", "score", "merge", "rescore"):
        fields[f"{phase}_ms"] = f"{stats[phase + '_nanos'] / n / 1e6:.4f}"
    # peak memory: the card's over this index, the host process's so far
    # (ru_maxrss is in KiB on Linux)
    if on_card:
        fields["device_peak_gb"] = f"{torch.cuda.max_memory_allocated() / 1e9:.2f}"
    fields["host_peak_rss_gb"] = \
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9:.2f}"
    return recall, fc, extra, fields, launches


def ivf_filtered_fallback(client, node, name: str, qv: np.ndarray,
                          n: int) -> None:
    """One filtered `_search` on an IVF index (an `ids` filter of every
    97th doc): the router falls back to the exhaustive corpus, whose exact
    route launches no kernel; the hits lie inside the filter, and the
    request's phases say `fallback_reason: filtered`."""
    from elasticsearch_tpu_torch.ops import dispatch
    store = node.index(name).store
    keep = set(range(0, n, 97))
    body = {"knn": {"field": "vec", "query_vector": qv.tolist(), "k": 10,
                    "num_candidates": 100,
                    "filter": {"ids": {"values": [str(i) for i in
                                                  sorted(keep)]}}},
            "size": 10}
    stats0 = dict(store.knn_stats)
    dispatch.reset_launches()
    t = time.perf_counter()
    ids, _ = _hits(client.ok("POST", f"/{name}/_search", body))
    ms = (time.perf_counter() - t) * 1e3
    launched = {k: c for k, c in dispatch.launches().items() if c}
    delta = {k: store.knn_stats[k] - stats0[k]
             for k in ("ivf_searches", "fallback_searches")}
    # the same body in this thread, whose phases the index keeps for it
    node.search(name, body)
    reason = node.index(name).vector_store.last_knn_phases.get(
        "fallback_reason")
    if len(ids) != 10 or not keep.issuperset(ids) or launched \
            or delta != {"ivf_searches": 0, "fallback_searches": 1} \
            or reason != "filtered":
        raise AssertionError(f"{name} filtered request: hits {ids}, "
                             f"launches {launched}, stats {delta}, "
                             f"fallback_reason {reason}")
    log("serve_cohere_ivf", index=name, filtered_request_ms=f"{ms:.3f}",
        fallback_reason=reason, filter_rows=len(keep))


N_IVF_GC = 131_072      # serve_ivf_compaction: the int8_ivf index's rows
IVF_GC_DELETED = 100    # ... of which one in this many is deleted


def serve_ivf_compaction(client, node, rng, n: int) -> int:
    """An `int8_ivf` index of n Cohere-shaped rows (768-d cosine, ~64 a
    cluster) built in one refresh (its router trained there), served
    through the fused kernel; then 1% of its docs deleted over `_bulk` and
    a timed refresh: the base keeps its rows, sets tombstones and drops its
    router, and serves masked on the exact route (no `ivf_fused_dense`
    launch) while the merge thread, held at its start, waits; then the
    merge runs (`drain()`): one `tombstone_gc` compaction whose retrain is
    the one `ivf_background_builds`, after which the router is back,
    every request launches `ivf_fused_dense` on `grouped` again, recall@10
    over the live rows is >= 0.90 and routing recall >= 0.95 (the
    `int8_ivf` gates). Returns the `ivf_fused_dense` launches."""
    import threading
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import ivf_fused as fused
    name = "cohere_gc"
    vecs = clustered32(rng, n, 768, n_centers=max(n // 64, 1))
    queries = vecs[rng.integers(0, n, 64)] + 0.3 * rng.standard_normal(
        (64, 768), dtype=np.float32)
    client.ok("PUT", f"/{name}", {
        "settings": {"number_of_shards": 1},
        "mappings": {"_source": {"enabled": False}, "properties": {"vec": {
            "type": "dense_vector", "dims": 768, "similarity": "cosine",
            "index_options": {"type": "int8_ivf"}}}}})
    svc = node.index(name)
    store = svc.store
    t = time.perf_counter()
    svc.index_many([str(i) for i in range(n)], vectors={"vec": vecs})
    client.ok("POST", f"/{name}/_refresh")
    build_s = time.perf_counter() - t
    client.ok("POST", f"/{name}/_search", knn_body("vec", queries[0]))
    gens = store._gens["vec"]

    def serve(live: np.ndarray, kernel, label: str):
        truth = live[exact_top(vecs[live], queries, 10, "cosine")]
        stats0 = dict(store.knn_stats)
        dispatch.reset_launches()
        lat, hits = [], []
        for qv in queries:
            t = time.perf_counter()
            resp = client.ok("POST", f"/{name}/_search", knn_body("vec", qv))
            lat.append((time.perf_counter() - t) * 1e3)
            hits.append([int(h["_id"]) for h in resp["hits"]["hits"]])
        launched = {k: c for k, c in dispatch.launches().items() if c}
        want = {kernel: len(queries)} if kernel else {}
        if launched != want:
            raise AssertionError(f"{name} {label}: launches {launched}, "
                                 f"expected {want}")
        _expect_served_variant(kernel, dispatch.variant_launches(),
                               len(queries))
        if any(set(h) - set(live.tolist()) for h in hits):
            raise AssertionError(f"{name} {label}: a deleted doc in a hit")
        recall = float(np.mean([len(set(h) & set(t.tolist())) / 10
                                for h, t in zip(hits, truth)]))
        delta = {k: store.knn_stats[k] - stats0[k] for k in (
            "ivf_searches", "generational_searches", "segment_legs_exact")}
        return (recall, statistics.median(lat), hits, delta,
                launched.get(fused.KERNEL_DENSE, 0))

    everyone = np.arange(n)
    recall0, p50_0, _, _, launched0 = serve(everyone, fused.KERNEL_DENSE,
                                            "built")
    # hold the merge thread at its start: the masked serving is observed
    # before the compaction installs
    held = threading.Event()
    execute = gens._execute

    def held_execute(spec, victims):
        held.wait(600)
        return execute(spec, victims)

    gens._execute = held_execute
    dead = np.sort(rng.choice(n, n // IVF_GC_DELETED, replace=False))
    resp = client.ok("POST", f"/{name}/_bulk",
                     [{"delete": {"_id": str(i)}} for i in dead.tolist()],
                     ndjson=True)
    if resp["errors"]:
        raise AssertionError(f"{name}: bulk delete {resp['items'][:3]}")
    st0 = store.segment_stats()
    t = time.perf_counter()
    client.ok("POST", f"/{name}/_refresh")
    refresh_s = time.perf_counter() - t
    st = store.segment_stats()
    live = np.setdiff1d(everyone, dead)
    if (st["full_rebuilds"] != st0["full_rebuilds"]
            or st["tombstoned_rows"] != len(dead) or st["generations"] != 1
            or store.field("vec").router is not None):
        raise AssertionError(f"{name} refresh after the deletes: {st}")
    recall1, p50_1, _, delta1, _ = serve(live, None, "tombstoned")
    if delta1 != {"ivf_searches": 0, "generational_searches": len(queries),
                  "segment_legs_exact": len(queries)} or recall1 < 0.90:
        raise AssertionError(f"{name} tombstoned: {delta1}, recall@10 "
                             f"{recall1}")
    t = time.perf_counter()
    held.set()
    gens.drain()
    drain_s = time.perf_counter() - t
    del gens._execute
    st2 = store.segment_stats()
    fc = store.field("vec")
    if (st2["ivf_background_builds"] - st0["ivf_background_builds"] != 1
            or st2["merge_reasons"] != {"tombstone_gc": 1}
            or st2["generations"] != 1 or st2["tombstoned_rows"]
            or fc.router is None):
        raise AssertionError(f"{name} after the compaction: {st2}")
    # the new router's nprobe tuner runs at its first search
    client.ok("POST", f"/{name}/_search", knn_body("vec", queries[0]))
    recall2, p50_2, hits2, _, launched2 = serve(live, fused.KERNEL_DENSE,
                                                "compacted")
    _, rows, _ = fc.router.search(queries, 10, nprobe=fc.router.index.nlist)
    full = [set(fc.row_map[r[r >= 0]].tolist()) for r in rows]
    routing = float(np.mean([len(set(h) & f) / 10
                             for h, f in zip(hits2, full)]))
    log("serve_ivf_compaction", index="int8_ivf", docs=n, deleted=len(dead),
        build_s=f"{build_s:.2f}", recall_at_10=recall0,
        p50_ms=f"{p50_0:.3f}", refresh_s=f"{refresh_s:.3f}",
        tombstoned_recall_at_10=recall1, tombstoned_p50_ms=f"{p50_1:.3f}",
        merge_s=f"{(st2['merge_nanos'] - st0['merge_nanos']) / 1e9:.3f}",
        drain_s=f"{drain_s:.3f}",
        ivf_background_builds=st2["ivf_background_builds"],
        compacted_recall_at_10=recall2, compacted_p50_ms=f"{p50_2:.3f}",
        routing_recall_at_10=routing, nlist=fc.router.index.nlist)
    if recall2 < 0.90 or routing < 0.95:
        raise AssertionError(f"{name} compacted: recall@10 {recall2}, "
                             f"routing recall {routing}")
    drop_index(client, name)
    return launched0 + launched2


def drop_index(client, name: str) -> None:
    """`DELETE /{name}` through the REST route: the index's stores and its
    hybrid executor (the token tile) let go of their device memory."""
    client.ok("DELETE", f"/{name}")
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_ivf(seed: int, n_gist: int, n_cohere: int,
                    device: str = "cuda", report=None,
                    compaction_only: bool = False) -> dict:
    """serve_gist, serve_cohere_ivf and serve_ivf_compaction: the tpu_ivf
    engine over HTTP. The one-shard `int8_ivf` index's p50s and recalls go
    into `report`. `compaction_only` runs serve_ivf_compaction alone."""
    from elasticsearch_tpu_torch.ops import ivf_fused as fused
    from elasticsearch_tpu_torch.server import build_server
    node, server = build_server(device=device, port=0,
                                settings=SERVE_SETTINGS)
    server.start()
    timer = IvfBuildTimer()
    total = {fused.KERNEL_DENSE: 0, fused.KERNEL_INT4: 0}
    try:
        client = Client(server.port)
        rng = np.random.default_rng(seed + 2)
        if compaction_only:
            total[fused.KERNEL_DENSE] += serve_ivf_compaction(
                client, node, np.random.default_rng(seed + 21),
                min(N_IVF_GC, n_cohere))
            return total

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
        drop_index(client, "gist")

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
        drop_index(client, "gist_l2")
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
            recall, fc, extra, fields, launches = serve_ivf(
                client, node, timer, name, {
                    "type": "dense_vector", "dims": 768,
                    "similarity": "cosine",
                    "index_options": {"type": otype}},
                cvecs, cq, "cosine", kernel)
            hits = extra["hits"]
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
            if otype == "int8_ivf" and report is not None:
                report.update({key: fields[key] for key in (
                    "docs", "p50_ms", "store_p50_ms", "recall_at_10",
                    "routing_recall_at_10")})
            if recall < gate:
                raise AssertionError(f"{name} recall@10 {recall} < {gate}")
            if otype == "int8_ivf":
                # concurrent clients: the grouped probe plan at Q > 1 from
                # request traffic; scores to the fused kernel's check
                conc = store_concurrent(
                    name, server.port, node.index(name), cq, extra,
                    recall, lambda sc: 1e-5 * max(1.0, max(map(abs, sc))),
                    {f"{kernel}/{fused.VARIANT_GROUPED}"})
                total[kernel] += conc.get(kernel, 0)
                for key, c in telemetry_profile(
                        client, name, knn_body("vec", cq[1]),
                        "ivf.fused_probe", kernel, ivf=True).items():
                    total[key] += c
                ivf_filtered_fallback(client, node, name, cq[0],
                                      len(cvecs))
            drop_index(client, name)
        del cvecs
        total[fused.KERNEL_DENSE] += timed(
            "serve_ivf_compaction", serve_ivf_compaction, client, node,
            np.random.default_rng(seed + 21), min(N_IVF_GC, n_cohere))
    finally:
        timer.close()
        server.stop()
    return total


def colbert_data(seed: int, n: int, dev):
    """ColBERTv2-shaped docs from `seed` (the geometry of the reference's
    late-interaction recall test): about 8 docs a topic, each doc's tokens
    scattered around its topic vector with noise 0.8, 8-180 tokens a doc
    (`colbert_counts`); a 768-d embedding a doc around a topic embedding;
    64 queries, each the first 32 tokens of one doc (of at least 32) plus
    0.1 noise, and that doc's embedding plus 0.3 noise. Tokens are made on
    `dev` in chunks and returned on the host."""
    rng = np.random.default_rng(seed + 3)
    counts = colbert_counts(rng, n)
    n_topics = max(n // 8, 1)
    doc_topic = np.arange(n) % n_topics
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    topics = torch.randn(n_topics, 128, generator=g, device=dev)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    tokens = np.empty((int(offsets[-1]), 128), dtype=np.float32)
    tok_topic = torch.from_numpy(np.repeat(doc_topic, counts)).to(dev)
    for lo in range(0, len(tokens), 1 << 20):
        hi = min(lo + (1 << 20), len(tokens))
        tokens[lo:hi] = (topics[tok_topic[lo:hi]] + 0.8 * torch.randn(
            hi - lo, 128, generator=g, device=dev)).cpu().numpy()
    emb_topics = torch.randn(n_topics, 768, generator=g, device=dev)
    emb = (emb_topics[torch.from_numpy(doc_topic).to(dev)] + torch.randn(
        n, 768, generator=g, device=dev)).cpu().numpy()
    src = rng.choice(np.nonzero(counts >= 32)[0], 64, replace=False)
    q_tokens = np.stack([tokens[offsets[i]:offsets[i] + 32] for i in src]) \
        + 0.1 * rng.standard_normal((64, 32, 128)).astype(np.float32)
    q_emb = emb[src] + 0.3 * rng.standard_normal((64, 768)).astype(
        np.float32)
    return tokens, counts, emb, q_tokens.astype(np.float32), q_emb, src


def exact_maxsim_top(tokens: np.ndarray, counts: np.ndarray,
                     q_tokens: np.ndarray, k: int, dev,
                     chunk: int = 1024) -> np.ndarray:
    """The recall oracle: exact f32 cosine MaxSim of every query against
    every doc's raw tokens (TF32 off), doc chunks padded to their longest
    doc; returns the top-k doc indices per query."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = torch.from_numpy(q_tokens).to(dev)
    q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-30)
    nq, tq, d = q.shape
    qf = q.reshape(nq * tq, d)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    scores = torch.empty(nq, len(counts), device=dev)
    for d0 in range(0, len(counts), chunk):
        d1 = min(d0 + chunk, len(counts))
        cnt = torch.from_numpy(counts[d0:d1]).to(dev)
        width = int(counts[d0:d1].max())
        toks = torch.from_numpy(tokens[offsets[d0]:offsets[d1]]).to(dev)
        toks = toks / toks.norm(dim=-1, keepdim=True).clamp_min(1e-30)
        doc = torch.repeat_interleave(torch.arange(d1 - d0, device=dev), cnt)
        pos = torch.arange(len(toks), device=dev) - (
            torch.cumsum(cnt, 0) - cnt)[doc]
        pad = torch.zeros(d1 - d0, width, d, device=dev)
        pad[doc, pos] = toks
        s = (qf @ pad.reshape(-1, d).T).reshape(nq, tq, d1 - d0, width)
        valid = torch.arange(width, device=dev)[None, :] < cnt[:, None]
        s = torch.where(valid, s, torch.full_like(s, float("-inf")))
        scores[:, d0:d1] = s.amax(-1).sum(1)
    return torch.topk(scores, k, dim=1).indices.cpu().numpy()


def _host_rrf(leg_rows, rank_constant: int = 60):
    """RRF recomputed on the host as a dict fold: (rows by (-score, row),
    their f64 scores)."""
    fused = {}
    for rows in leg_rows:
        for rank, row in enumerate(rows.tolist()):
            fused[row] = fused.get(row, 0.0) + 1.0 / (rank_constant + rank + 1)
    ordered = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))
    return [r for r, _ in ordered], [sc for _, sc in ordered]


def _hybrid_body(q_emb, q_tok, source=False):
    return {"rank": {"rrf": {}}, "size": 10, "_source": source,
            "sub_searches": [
                {"query": {"knn": {"field": "emb",
                                   "query_vector": q_emb.tolist(),
                                   "k": 10, "num_candidates": 100}}},
                {"query": {"late_interaction": {
                    "field": "colv", "query_tokens": q_tok.tolist(),
                    "k": 10}}}]}


def serve_colbert_index(client, node, name, encoding, oversample, data,
                        top, first=300, levels=()):
    """One hybrid index: create, `_bulk` `first` docs (checked by one
    search on a scratch copy, `small_index_check`), load the rest through
    its one shard's `Engine.index_many` (token arrays go to an engine: the
    routed `IndexService.index_many` takes only dense vectors), refresh
    once, one warm-up search (it builds the token tile), then the timed
    requests over HTTP, each checked against its legs and host RRF; `top`
    holds the oracle's top-10 docs of each query. Then, for each C in `levels`, the concurrent
    clients of `serve_concurrent` (128 bodies a level). Returns the MaxSim
    leg's recall@10, the fields to log and the launches of the timed and
    concurrent requests."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    from elasticsearch_tpu_torch.ops import maxsim
    from elasticsearch_tpu_torch.search.hybrid_plan import compile_plan
    tokens, counts, emb, q_tokens, q_emb, src = data
    n = len(counts)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    on_card = node.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    body = {"settings": {"number_of_shards": 1},
            "mappings": {"properties": {
                "emb": {"type": "dense_vector", "dims": 768,
                        "similarity": "cosine",
                        "index_options": {"type": "flat"}},
                "colv": {"type": "rank_vectors", "dims": 128,
                         "similarity": "cosine",
                         "index_options": {"encoding": encoding,
                                           "oversample": oversample}}}}}
    client.ok("PUT", f"/{name}", body)
    first = min(first, n)
    ops = []
    for i in range(first):
        ops += [{"index": {"_id": str(i)}},
                {"emb": emb[i].tolist(),
                 "colv": tokens[offsets[i]:offsets[i + 1]].tolist()}]

    def small_search(path):
        probe = 7
        hits = client.ok("POST", path, _hybrid_body(
            emb[probe], tokens[offsets[probe]:offsets[probe] + 16],
            source=True))["hits"]["hits"]
        if hits[0]["_id"] != str(probe) \
                or len(hits[0]["_source"]["colv"]) != counts[probe]:
            raise AssertionError(f"small-index hybrid search: {hits[:2]}")

    small_index_check(client, name, body, ops, small_search)
    resp = client.ok("POST", f"/{name}/_bulk", ops, ndjson=True)
    if resp["errors"]:
        raise AssertionError(f"bulk errors: {resp['items'][:3]}")

    t0 = time.perf_counter()
    node.index(name).engine.index_many(
        [str(i) for i in range(first, n)], vectors={"emb": emb[first:]},
        token_vectors={"colv": (tokens[offsets[first]:], counts[first:])})
    client.ok("POST", f"/{name}/_refresh")
    refresh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    client.ok("POST", f"/{name}/_search", _hybrid_body(q_emb[0], q_tokens[0]))
    first_search_s = time.perf_counter() - t0

    ex = node._hybrid[name]
    late0, ex0 = dict(ex.late.stats), dict(ex.stats)
    dispatch.reset_launches()
    lat, responses = [], []
    for qe, qt in zip(q_emb, q_tokens):
        t = time.perf_counter()
        resp = client.ok("POST", f"/{name}/_search", _hybrid_body(qe, qt))
        lat.append((time.perf_counter() - t) * 1e3)
        responses.append(resp["hits"])
    launches = dispatch.launches()
    variants = dispatch.variant_launches()
    kernel = maxsim.KERNEL_INT4 if encoding == "int4" else \
        maxsim.KERNEL_DENSE
    want = {kernel: len(q_emb), kb.KERNEL_BF16: len(q_emb)}
    if {k: c for k, c in launches.items() if c} != want:
        raise AssertionError(f"{name}: launches {launches} for "
                             f"{len(q_emb)} requests; expected {want}")
    want = {f"{kb.KERNEL_BF16}/{kb.VARIANT_TMA}": len(q_emb),
            f"{kernel}/{maxsim.VARIANT_WARP}": len(q_emb)}
    if {k: c for k, c in variants.items() if c} != want:
        raise AssertionError(f"{name}: variant launches {variants}; "
                             f"expected {want}")
    late = {k: v - late0[k] for k, v in ex.late.stats.items()}
    # the executor's stages (plan + bind, both legs, RRF, fetch) per request
    stages = {k: (ex.stats[k] - ex0[k]) / len(q_emb) / 1e6
              for k in ("plan_nanos", "score_nanos", "fuse_nanos",
                        "hydrate_nanos")}

    # each response against RRF of its two legs, recomputed on the host;
    # the MaxSim leg's rows against the exact oracle
    reader = node.index(name).engine.acquire_searcher()
    mappings = node.index(name).mapper_service
    mapper = mappings.get("colv")
    leg_lat, leg_rows, hit_total, compile_ns = [], [], 0, 0
    host = []     # host RRF of each query's legs: (ids, scores, total)
    for qi, (qe, qt) in enumerate(zip(q_emb, q_tokens)):
        body = _hybrid_body(qe, qt)
        t = time.perf_counter_ns()
        plan = compile_plan(body, mappings)
        compile_ns += time.perf_counter_ns() - t
        rows, scores = _host_rrf(
            ex.score_legs(reader, [plan], [plan.bind(body)])[0])
        host.append(([reader.get_id(r) for r in rows[:10]], scores[:10],
                     len(rows)))
        got = responses[qi]
        if [h["_id"] for h in got["hits"]] != host[qi][0] \
                or [h["_score"] for h in got["hits"]] != host[qi][1] \
                or got["total"]["value"] != len(rows):
            raise AssertionError(f"{name}: request {qi} differs from host "
                                 f"RRF of its legs")
        hit_total += len(got["hits"])
        t = time.perf_counter()
        (rows, _), = ex.late.search_batch(reader, mapper, [(qt, 1.0)], 10)
        leg_lat.append((time.perf_counter() - t) * 1e3)
        leg_rows.append(rows)
    recall = float(np.mean([len(set(r.tolist()) & set(t.tolist())) / 10
                            for r, t in zip(leg_rows, top)]))
    lf = ex.late.field(reader, mapper)
    # the leg's recall at other windows: what the choice of oversample buys
    by_oversample = {}
    served = lf.oversample
    try:
        for ov in (4, 8, 16):
            lf.oversample = ov
            got = lf.search_batch([(qt, 1.0) for qt in q_tokens], 10)
            by_oversample[ov] = float(np.mean([
                len(set(r.tolist()) & set(t.tolist())) / 10
                for (r, _), t in zip(got, top)]))
    finally:
        lf.oversample = served
    fs = ex.late.field_stats()["colv"]
    fields = dict(
        docs=fs["docs"], tokens=fs["tokens"], cap=fs["cap"], n_pad=lf.n_pad,
        encoding=fs["encoding"], oversample=oversample,
        coarse_window=lf.coarse_window(10), requests=len(q_emb),
        refresh_s=f"{refresh_s:.2f}", first_search_s=f"{first_search_s:.2f}",
        p50_ms=f"{statistics.median(lat):.3f}",
        leg_store_p50_ms=f"{statistics.median(leg_lat):.3f}",
        recall_at_10=recall, hits_checked=hit_total,
        recall_by_oversample=json.dumps(by_oversample),
        tile_gb=f"{fs['tile_bytes'] / 1e9:.3f}",
        launches=json.dumps(launches))
    for phase in ("coarse", "rescore", "select"):
        fields[f"{phase}_ms"] = \
            f"{late[phase + '_nanos'] / late['searches'] / 1e6:.4f}"
    for stage, ms in stages.items():
        fields[f"{stage.split('_')[0]}_stage_ms"] = f"{ms:.4f}"
    # compile_plan alone, the part of the plan stage a plan cache could save
    fields["compile_plan_us"] = f"{compile_ns / len(q_emb) / 1e3:.2f}"
    if on_card:
        fields["device_peak_gb"] = \
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f}"
    fields["host_peak_rss_gb"] = \
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9:.2f}"
    if levels:
        launches = dict(launches)
        conc = colbert_concurrent(client, node, name, ex, q_emb, q_tokens,
                                  host, top, recall, levels)
        for kname, c in conc.items():
            launches[kname] = launches.get(kname, 0) + c
    return recall, fields, launches


def colbert_concurrent(client, node, name, ex, q_emb, q_tokens, host, top,
                       recall, levels) -> dict:
    """serve_concurrent over a hybrid index: each response against its
    query's batch-1 answer, which equals host RRF of its legs (checked by
    the caller), so RRF scores compare exactly; then the 64 bodies' legs
    run as one batch must give the same RRF answers and no lower MaxSim
    recall@10. Returns the launches of the levels."""
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    from elasticsearch_tpu_torch.ops import maxsim
    from elasticsearch_tpu_torch.search.hybrid_plan import compile_plan
    bodies = [_hybrid_body(qe, qt) for qe, qt in zip(q_emb, q_tokens)]

    def check(qi, payload):
        hits = payload["hits"]
        if hits["total"]["value"] != host[qi][2]:
            raise AssertionError(f"{name} query {qi}: total "
                                 f"{hits['total']} against {host[qi][2]}")
        return against_batch1(f"{name} query {qi}",
                              [h["_id"] for h in hits["hits"]],
                              [h["_score"] for h in hits["hits"]],
                              host[qi][0], host[qi][1], 0.0)

    conc = serve_concurrent(
        name, client.port, f"/{name}/_search", bodies, levels,
        2 * len(bodies), check, lambda: dict(ex.batcher.sched),
        (ex.batcher, "_dispatch_fn", 0),
        {f"{kb.KERNEL_BF16}/{kb.VARIANT_TMA}",
         f"{maxsim.KERNEL_DENSE}/{maxsim.VARIANT_WARP}"})
    # the legs of all 64 bodies as one batch (Q = 64 in both stores)
    reader = node.index(name).engine.acquire_searcher()
    plans = [compile_plan(b, node.index(name).mapper_service)
             for b in bodies]
    legs = ex.score_legs(reader, plans, [p.bind(b)
                                         for p, b in zip(plans, bodies)])
    ties = 0
    for qi, body_legs in enumerate(legs):
        rows, scores = _host_rrf(body_legs)
        ties += against_batch1(f"{name} batched legs, query {qi}",
                               [reader.get_id(r) for r in rows[:10]],
                               scores[:10], host[qi][0], host[qi][1], 0.0)
    batched = float(np.mean([
        len(set(body_legs[1][:10].tolist()) & set(t.tolist())) / 10
        for body_legs, t in zip(legs, top)]))
    log("serve_concurrent", index=name, batched_legs=len(bodies),
        ties=ties, maxsim_recall_at_10=batched)
    if batched < recall:
        raise AssertionError(f"{name}: MaxSim recall@10 of the batched legs "
                             f"{batched} < the sequential {recall}")
    return conc


def phase_serve_colbert(seed: int, n: int, device: str = "cuda") -> dict:
    """serve_colbert: the knn + late_interaction hybrid over HTTP, at int8
    (the mapping's default oversample 4; recall@10 must reach 0.95) and at
    int4 (oversample 8, as the reference's int4 recall test uses). On this
    shape int4's rounding reorders near-tied 9th and 10th neighbours and
    its recall sits just under 0.95 (PERF.md, open questions): it is logged
    against that gate and held to 0.90, which only a broken int4 path
    misses."""
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    from elasticsearch_tpu_torch.ops import maxsim
    from elasticsearch_tpu_torch.server import build_server
    dev = torch.device(device)
    t0 = time.perf_counter()
    data = colbert_data(seed, n, dev)
    top = exact_maxsim_top(data[0], data[1], data[3], 10, dev)
    log("serve_colbert", data_s=f"{time.perf_counter() - t0:.2f}",
        docs=n, tokens=len(data[0]))
    node, server = build_server(device=device, port=0,
                                settings=SERVE_SETTINGS)
    server.start()
    total = {kb.KERNEL_BF16: 0, maxsim.KERNEL_DENSE: 0, maxsim.KERNEL_INT4: 0}
    try:
        client = Client(server.port)
        for encoding, oversample, floor in (("int8", 4, 0.95),
                                            ("int4", 8, 0.90)):
            name = f"colbert_{encoding}"
            recall, fields, launches = serve_colbert_index(
                client, node, name, encoding, oversample, data, top,
                levels=(1, 8) if encoding == "int8" else ())
            for kname, c in launches.items():
                total[kname] = total.get(kname, 0) + c
            log("serve_colbert", index=name, meets_0_95=recall >= 0.95,
                **fields)
            if recall < floor:
                raise AssertionError(f"{name} MaxSim leg recall@10 {recall} "
                                     f"< {floor}")
            drop_index(client, name)
    finally:
        server.stop()
    return total


# ------------------------------------------------------------ serve_filtered

LAION_SOURCE = ["nsfw", "width", "aesthetic", "watermark"]
NSFW_TAGS = np.array(["UNLIKELY", "UNSURE", "NSFW"])


def laion_columns(seed: int, n: int) -> dict:
    """LAION-5B's metadata columns for n docs, from the seed: NSFW
    (UNLIKELY / UNSURE / NSFW at 0.90 / 0.07 / 0.03, as codes 0-2), WIDTH
    (log-normal, median 512), AESTHETIC_SCORE (normal around 5 in [0, 10],
    float32) and pwatermark > 0.5 (true for about 0.1)."""
    rng = np.random.default_rng([seed, 5])
    return {"nsfw": rng.choice(3, n, p=[0.90, 0.07, 0.03]),
            "width": np.maximum(rng.lognormal(np.log(512), 0.6, n),
                                1).astype(np.int64),
            "aesthetic": np.clip(rng.normal(5.0, 1.0, n), 0,
                                 10).astype(np.float32),
            "watermark": rng.random(n) < 0.1}


def laion_source(cols: dict, i: int) -> dict:
    return {"nsfw": str(NSFW_TAGS[cols["nsfw"][i]]),
            "width": int(cols["width"][i]),
            "aesthetic": float(cols["aesthetic"][i]),
            "watermark": bool(cols["watermark"][i])}


# (name, filter, the docs it lets through, from the generated columns):
# about 90%, 7%, 1% and 1% of the rows (the fourth's clauses are
# independent here, so it keeps ~0.1 x 0.1 of them), then one that keeps
# fewer than k rows
LAION_FILTERS = (
    ("nsfw_unlikely", {"term": {"nsfw": "UNLIKELY"}},
     lambda c: c["nsfw"] == 0),
    ("aesthetic_gte_6_5", {"range": {"aesthetic": {"gte": 6.5}}},
     lambda c: c["aesthetic"] >= 6.5),
    ("unsure_wide", {"bool": {"filter": [
        {"term": {"nsfw": "UNSURE"}}, {"range": {"width": {"gte": 1024}}}]}},
     lambda c: (c["nsfw"] == 1) & (c["width"] >= 1024)),
    ("flagged_watermarked", {"bool": {
        "filter": [{"terms": {"nsfw": ["UNSURE", "NSFW"]}},
                   {"term": {"watermark": True}}],
        "must_not": [{"range": {"aesthetic": {"lt": 3}}}]}},
     lambda c: (c["nsfw"] >= 1) & c["watermark"] & ~(c["aesthetic"] < 3)),
    ("under_k", {"bool": {"filter": [
        {"term": {"nsfw": "NSFW"}}, {"term": {"watermark": True}},
        {"range": {"aesthetic": {"gte": 7.8}}}]}},
     lambda c: (c["nsfw"] == 2) & c["watermark"] & (c["aesthetic"] >= 7.8)),
)


def laion_body(qv: np.ndarray, filt=None, k: int = 10) -> dict:
    spec = {"field": "vec", "query_vector": qv.tolist(), "k": k,
            "num_candidates": 100}
    if filt is not None:
        spec["filter"] = filt
    return {"knn": spec, "size": k, "_source": LAION_SOURCE}


def _hits(payload):
    hits = payload["hits"]["hits"]
    return [int(h["_id"]) for h in hits], [h["_score"] for h in hits]


def should_sum(legs):
    """The reference's bool.should of legs recomputed on the host: each
    leg a {doc: score} map; a doc's score is the float32 sum of its legs'
    scores in leg order; the top 10 by (score desc, doc asc); the total
    counted to 10,000 (relation gte beyond it). Returns (ids, scores,
    total)."""
    acc = {}
    for leg in legs:
        for doc, sc in leg.items():
            acc[doc] = np.float32(acc.get(doc, np.float32(0.0))
                                  + np.float32(sc))
    ranked = sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
    total = ({"value": len(acc), "relation": "eq"} if len(acc) <= 10_000
             else {"value": 10_000, "relation": "gte"})
    return [d for d, _ in ranked], [float(v) for _, v in ranked], total


def _bf16_matmul_f32(q, c):
    """One bf16 product with f32 output (and its name): `torch.mm(out_dtype=)`
    where this PyTorch has it, else a bf16 product widened after."""
    try:
        return torch.mm(q, c.T, out_dtype=torch.float32), \
            "torch.mm(bf16, bf16, out_dtype=float32)"
    except (TypeError, RuntimeError):
        return torch.mm(q, c.T).float(), "torch.mm(bf16, bf16).float()"


def exact_route_row(store, fc, masks, queries, dev) -> dict:
    """`knn.exact` (`ops/knn.py::knn_search`, the filtered route) on the
    served corpus with a [Q, N] mask at Q = 1 and 32: per launch and burst
    times, its bound (the bf16 corpus, the mask, the queries and the
    boards each moved once; 2 Q N D bf16 operations), one bf16
    `torch.mm` with f32 output of the same product, and the card's peak
    memory over one filtered batch of 32 through the store."""
    from elasticsearch_tpu_torch.ops import knn as knn_ops
    from elasticsearch_tpu_torch.vectors.store import filter_mask
    n_pad, d = fc.corpus.matrix.shape
    out = {}
    for nq in (1, 32):
        q = torch.from_numpy(queries[:nq]).to(dev)
        mask = filter_mask(fc, masks[:nq], nq, n_pad).to(dev)

        def run(q=q, mask=mask):
            return knn_ops.knn_search(q, fc.corpus, 10, metric=fc.metric,
                                      filter_mask=mask)
        ms, burst = time_ms(run, iters=10), burst_ms(run, n=10)
        qb = q.to(torch.bfloat16)
        library = _bf16_matmul_f32(qb, fc.corpus.matrix)[1]
        lib = time_ms(lambda: _bf16_matmul_f32(qb, fc.corpus.matrix),
                      iters=10)
        nbytes = n_pad * d * 2 + nq * n_pad + nq * d * 4 + nq * 10 * 12
        bound, by = bound_ms(nbytes, 2 * nq * n_pad * d, BF16_OPS_PER_S)
        out[nq] = dict(ms=ms, burst_ms=burst, bound_ms=bound, bound_by=by,
                       library_ms=lib)
        out["library"] = library
    # one filtered batch of 32 through the store, from an idle card
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    store.search_many("vec", list(queries[:32]), 10,
                      filter_rows=masks[:32])
    torch.cuda.synchronize()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["batch_extra_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    return out


def filter_cache_line(client, node, svc, store, name, filt, queries,
                      warm_lat, got, got_scores, qc_hits, qc_misses) -> None:
    """serve_filtered's `cache` line for one filter: the node query cache
    caches each clause of a `bool`'s `filter` list (not its `must_not`,
    not a top-level filter). Warm: the phase's requests of the filter as
    they came (the first one fills the cache; a clause an earlier filter
    shares is already there); each cached clause must have missed at most
    once and hit on every other request. Cold: the first COLD_REQUESTS
    queries again, `_cache/clear` (untimed) before each, each answer equal
    to its warm one; both p50s are over those COLD_REQUESTS queries. The
    filter's host evaluation on the combined reader the requests search,
    uncached and through the node's cache, and its share of each p50, on
    the host's clock."""
    from elasticsearch_tpu_torch.search.queries import (
        SearchContext, parse_query)
    clauses = len(filt["bool"].get("filter", [])) if "bool" in filt else 0
    if qc_hits + qc_misses != len(queries) * clauses \
            or qc_misses > clauses:
        raise AssertionError(f"serve_filtered {name}: query cache "
                             f"{qc_hits} hits, {qc_misses} misses over "
                             f"{len(queries)} requests of {clauses} cached "
                             f"clauses")
    cold_lat = []
    for qi, qv in enumerate(queries[:COLD_REQUESTS]):
        node.clear_cache(svc.name)
        t = time.perf_counter()
        resp = client.ok("POST", f"/{svc.name}/_search",
                         laion_body(qv, filt))
        cold_lat.append((time.perf_counter() - t) * 1e3)
        if _hits(resp) != (got[qi], got_scores[qi]):
            raise AssertionError(f"serve_filtered {name} cold request "
                                 f"{qi}: {_hits(resp)} against the warm "
                                 f"{got[qi]} {got_scores[qi]}")
    reader = svc.combined_reader()
    filter_lat = {}
    for label, cache in (("cold", None), ("warm", node.caches.query)):
        ctx = SearchContext(reader, svc.mapper_service, store, svc.settings,
                            query_cache=cache)
        parse_query(filt).execute(ctx)       # fill the cache
        filter_lat[label] = []
        for _ in range(5):
            t = time.perf_counter()
            parse_query(filt).execute(ctx)
            filter_lat[label].append((time.perf_counter() - t) * 1e3)
    warm_lat = warm_lat[:COLD_REQUESTS]
    cold_p50, warm_p50 = (statistics.median(cold_lat),
                          statistics.median(warm_lat))
    cold_f, warm_f = (statistics.median(filter_lat["cold"]),
                      statistics.median(filter_lat["warm"]))
    if clauses and not warm_f < cold_f:
        raise AssertionError(f"serve_filtered {name}: the cached filter "
                             f"took {warm_f:.3f} ms, uncached {cold_f:.3f}")
    log("serve_filtered", cache=name, cached_clauses=clauses,
        cold_requests=len(cold_lat), warm_requests=len(warm_lat),
        cold_p50_ms=f"{cold_p50:.3f}", warm_p50_ms=f"{warm_p50:.3f}",
        cold_filter_ms=f"{cold_f:.3f}", warm_filter_ms=f"{warm_f:.3f}",
        cold_filter_share=f"{cold_f / cold_p50:.3f}",
        warm_filter_share=f"{warm_f / warm_p50:.3f}",
        query_cache_hits=qc_hits, query_cache_misses=qc_misses)


def phase_serve_filtered(seed: int, n: int, device: str = "cuda",
                         body_only: bool = False,
                         dsl_only: bool = False,
                         search_api_only: bool = False) -> dict:
    """serve_filtered: BASELINE config 5 (filtered kNN, LAION 512-d CLIP
    embeddings), cut from 5M to `n` (1M) rows for host memory and the
    run's time. A cosine `flat` (bf16) index of 512-d clustered rows (as
    `bench.py` makes them) with LAION's metadata columns beside each
    vector (`laion_columns`): 2,000 docs over `_bulk`, the rest through
    `IndexService.index_many(sources=, vectors=)`.

    For each filter of LAION_FILTERS, 64 `_search {knn: {..., filter},
    k: 10}` requests over HTTP: recall@10 >= 0.95 against exact f32 numpy
    over the rows the filter lets through; every hit inside the filter
    (checked on the generated columns); hits and total min(k, passing
    rows); no binned launch. Logged a filter: HTTP p50 (with the node
    query cache on, so a `bool`'s `filter` clauses run warm after the
    first request), store p50, the filter's host evaluation (no cache),
    the mask build, and the exact route on the card (CUDA events); then
    its `cache` line (`filter_cache_line`). Then 64 unfiltered requests
    (the batch-1 answers of what follows), 16 `knn` + `query: {term:
    {nsfw: NSFW}}` and 16 two-element `knn` lists, each equal to the should-sum of its legs
    recomputed on the host and launching the bf16 binned kernel once a
    leg; the exact route's kernel row (`exact_route_row`); and
    serve_concurrent at C = 1 and 8 over a mix of the filters and
    unfiltered bodies, every answer equal to its batch-1 answer (filtered
    within the exact route's tolerance, unfiltered within one packing
    quantum, as a mixed batch scores them exactly) and a largest batch
    above 1 at C = 8; then the search body's part (`serve_body_laion`)
    and the scripts of the `[dsl]` part (`dsl_laion`), then the scrolls
    of the `[search_api]` part (`search_api_laion`). `body_only` runs
    the unfiltered requests and the body part alone, `dsl_only` the
    unfiltered requests and the `[dsl]` part alone, `search_api_only` the
    `[search_api]` part alone. Returns the binned launches."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn as knn_ops
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    from elasticsearch_tpu_torch.search.queries import (
        SearchContext, parse_query)
    from elasticsearch_tpu_torch.server import build_server
    from elasticsearch_tpu_torch.vectors.store import filter_mask
    dev = torch.device(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 4)
    vecs = clustered32(rng, n, 512)
    queries = vecs[rng.integers(0, n, 64)] + 0.3 * rng.standard_normal(
        (64, 512), dtype=np.float32)
    cols = laion_columns(seed, n)
    sources = [laion_source(cols, i) for i in range(n)]
    log("serve_filtered", data_s=f"{time.perf_counter() - t0:.2f}", docs=n)
    node, server = build_server(device=device, port=0,
                                settings=SERVE_SETTINGS)
    server.start()
    total = {kb.KERNEL_BF16: 0}
    try:
        client = Client(server.port)
        client.ok("PUT", "/laion", {
            "settings": {"number_of_shards": 1},
            "mappings": {"properties": {
                "vec": {"type": "dense_vector", "dims": 512,
                        "similarity": "cosine"},
                "nsfw": {"type": "keyword"}, "width": {"type": "integer"},
                "aesthetic": {"type": "float"},
                "watermark": {"type": "boolean"}}}})
        first = min(2000, n)
        ops = []
        for i in range(first):
            ops += [{"index": {"_id": str(i)}},
                    dict(sources[i], vec=vecs[i].tolist())]
        if client.ok("POST", "/laion/_bulk", ops, ndjson=True)["errors"]:
            raise AssertionError("serve_filtered: bulk errors")
        t0 = time.perf_counter()
        svc = node.index("laion")
        if n > first:
            svc.index_many([str(i) for i in range(first, n)],
                           sources[first:], vectors={"vec": vecs[first:]})
        client.ok("POST", "/laion/_refresh")
        ingest_s = time.perf_counter() - t0
        del sources
        store = svc.store
        fc = store.field("vec")
        n_pad = fc.corpus.matrix.shape[0]
        reader = svc.engine.acquire_searcher()
        ctx = SearchContext(reader, svc.mapper_service, store, svc.settings)
        log("serve_filtered", ingest_s=f"{ingest_s:.2f}",
            host_peak_rss_gb=f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9:.2f}")

        if search_api_only:
            search_api_laion(client, node, cols)
            drop_index(client, "laion")
            return total
        if body_only or dsl_only:
            plain, _ = laion_unfiltered(client, queries)
            total[kb.KERNEL_BF16] += len(queries)
            total[kb.KERNEL_BF16] += (
                serve_body_laion(client, svc, cols, queries, plain)
                if body_only else
                dsl_laion(client, svc, vecs, cols, queries, plain))
            drop_index(client, "laion")
            return total

        answers, filter_rows = {}, {}
        for name, filt, passes in LAION_FILTERS:
            filter_lat = []
            for _ in range(5):
                t = time.perf_counter()
                rows = parse_query(filt).execute(ctx).rows
                filter_lat.append((time.perf_counter() - t) * 1e3)
            want_rows = np.nonzero(passes(cols))[0]
            if not np.array_equal(rows, want_rows):
                raise AssertionError(f"serve_filtered {name}: the filter "
                                     f"kept {len(rows)} rows, the columns "
                                     f"say {len(want_rows)}")
            filter_rows[name] = rows
            passing = np.zeros(n, dtype=bool)
            passing[rows] = True
            expect = min(10, len(rows))
            dispatch.reset_launches()
            stats0 = dict(store.knn_stats)
            qc0 = (node.caches.query.hits, node.caches.query.misses)
            lat, got, got_scores = [], [], []
            for qv in queries:
                t = time.perf_counter()
                resp = client.ok("POST", "/laion/_search",
                                 laion_body(qv, filt))
                lat.append((time.perf_counter() - t) * 1e3)
                ids, scores = _hits(resp)
                if len(ids) != expect or resp["hits"]["total"] != {
                        "value": expect, "relation": "eq"} \
                        or not all(np.isfinite(scores)):
                    raise AssertionError(f"serve_filtered {name}: "
                                         f"{resp['hits']}, expected "
                                         f"{expect} hits")
                if not passing[ids].all():
                    raise AssertionError(f"serve_filtered {name}: hits "
                                         f"{ids} outside the filter")
                got.append(ids)
                got_scores.append(scores)
            qc_hits = node.caches.query.hits - qc0[0]
            qc_misses = node.caches.query.misses - qc0[1]
            launched = {k: c for k, c in dispatch.launches().items() if c}
            if launched:
                raise AssertionError(f"serve_filtered {name}: filtered "
                                     f"requests launched {launched}")
            exact_n = store.knn_stats["searches"] - stats0["searches"]
            answers[name] = (got, got_scores)
            if len(rows) > expect:
                truth = rows[exact_top(vecs[rows], queries, expect,
                                       "cosine")]
            else:        # every passing row is a true neighbour
                truth = [rows] * len(queries)
            recall = float(np.mean([len(set(g) & set(t.tolist()))
                                    / max(expect, 1)
                                    for g, t in zip(got, truth)])) \
                if expect else 1.0
            if recall < 0.95:
                raise AssertionError(f"serve_filtered {name} recall@10 "
                                     f"{recall} < 0.95")
            store_lat = []
            for qv in queries:
                t = time.perf_counter()
                store.search("vec", qv, 10, filter_rows=rows, reader=reader)
                store_lat.append((time.perf_counter() - t) * 1e3)
            mask_lat = []
            for _ in range(5):
                t = time.perf_counter()
                host_mask = filter_mask(fc, [rows], 1, n_pad)
                mask_lat.append((time.perf_counter() - t) * 1e3)
            mask = host_mask.to(dev)
            q_dev = torch.from_numpy(queries[:1]).to(dev)
            route_ms = time_ms(lambda: knn_ops.knn_search(
                q_dev, fc.corpus, 10, metric=fc.metric, filter_mask=mask),
                iters=10)
            log("serve_filtered", filter=name, selectivity=len(rows) / n,
                passing_rows=len(rows), requests=len(queries),
                p50_ms=f"{statistics.median(lat):.3f}",
                store_p50_ms=f"{statistics.median(store_lat):.3f}",
                filter_ms=f"{statistics.median(filter_lat):.3f}",
                mask_ms=f"{statistics.median(mask_lat):.3f}",
                exact_route_ms=f"{route_ms:.3f}", recall_at_10=recall,
                store_searches=exact_n, binned_launches=0)
            filter_cache_line(client, node, svc, store, name, filt, queries,
                              lat, got, got_scores, qc_hits, qc_misses)

        # unfiltered: the batch-1 answers the combinations, the
        # concurrent levels and the body part are held to
        plain, lat = laion_unfiltered(client, queries)
        total[kb.KERNEL_BF16] += len(queries)
        nsfw_docs = {int(i): 1.0 for i in np.nonzero(cols["nsfw"] == 2)[0]}
        dispatch.reset_launches()
        combos = []
        for j in range(16):
            legs = [dict(zip(*plain[j]))]
            body = {"knn": laion_body(queries[j])["knn"], "size": 10,
                    "query": {"term": {"nsfw": "NSFW"}},
                    "_source": LAION_SOURCE}
            combos.append((f"knn+query {j}", body, [nsfw_docs] + legs))
            a, b = (j + 16) % 64, (j + 17) % 64
            body = {"knn": [laion_body(queries[a])["knn"],
                            laion_body(queries[b])["knn"]], "size": 10,
                    "_source": LAION_SOURCE}
            combos.append((f"knn list {j}", body,
                           [dict(zip(*plain[a])), dict(zip(*plain[b]))]))
        combo_lat = []
        for label, body, legs in combos:
            t = time.perf_counter()
            resp = client.ok("POST", "/laion/_search", body)
            combo_lat.append((time.perf_counter() - t) * 1e3)
            ids, scores = _hits(resp)
            want_ids, want_scores, want_total = should_sum(legs)
            if ids != want_ids or resp["hits"]["total"] != want_total \
                    or any(abs(a - b) > 1e-6
                           for a, b in zip(scores, want_scores)):
                raise AssertionError(
                    f"serve_filtered {label}: {ids} {scores} "
                    f"{resp['hits']['total']}; the host's should-sum "
                    f"{want_ids} {want_scores} {want_total}")
        launched = {k: c for k, c in dispatch.launches().items() if c}
        if launched != {kb.KERNEL_BF16: 48}:
            raise AssertionError(f"serve_filtered knn + query and knn "
                                 f"lists: launches {launched}, expected 48")
        total[kb.KERNEL_BF16] += 48
        log("serve_filtered", unfiltered_p50_ms=f"{statistics.median(lat):.3f}",
            combined_requests=len(combos),
            combined_p50_ms=f"{statistics.median(combo_lat):.3f}",
            combined_binned_launches=48)

        # the exact route's kernel row: masks of the five filters in turn
        masks = [filter_rows[LAION_FILTERS[i % len(LAION_FILTERS)][0]]
                 for i in range(64)]
        row = exact_route_row(store, fc, masks, queries, dev)
        log("exact_route", shape=f"N={n_pad} D=512 bf16 [Q,N] mask",
            **{f"q{nq}_{key}": (f"{v:.4f}" if isinstance(v, float) else v)
               for nq in (1, 32) for key, v in row[nq].items()},
            peak_gb=f"{row['peak_gb']:.2f}",
            batch_extra_gb=f"{row['batch_extra_gb']:.2f}",
            library=repr(row["library"]))

        # concurrent clients: a mix of the filters and unfiltered bodies
        plan = [(qi, qi % (len(LAION_FILTERS) + 1)) for qi in range(64)]
        bodies = [laion_body(queries[qi],
                             LAION_FILTERS[fi - 1][1] if fi else None)
                  for qi, fi in plan]

        def check(j, payload):
            qi, fi = plan[j]
            ids, scores = _hits(payload)
            want_ids, want_scores = (
                plain[qi] if fi == 0
                else (answers[LAION_FILTERS[fi - 1][0]][0][qi],
                      answers[LAION_FILTERS[fi - 1][0]][1][qi]))
            # an unfiltered request batched with a filtered one is scored
            # exactly: one packing quantum from its binned batch-1 answer
            tol = BF16_QUANTUM / 2 + 1e-6 if fi == 0 else 1e-5
            return against_batch1(f"serve_filtered concurrent body {j}",
                                  ids, scores, want_ids, want_scores, tol)

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        conc = serve_concurrent(
            "laion", server.port, "/laion/_search", bodies, (1, 8),
            CONCURRENT_REQUESTS, check, svc.vector_store.scheduler_stats,
            (store, "_dispatch_many", 3),
            {f"{kb.KERNEL_BF16}/{kb.VARIANT_TMA}"}, coalesce_at=8)
        total[kb.KERNEL_BF16] += conc.get(kb.KERNEL_BF16, 0)
        if dev.type == "cuda":
            log("serve_filtered", concurrent_device_peak_gb=
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        total[kb.KERNEL_BF16] += serve_body_laion(client, svc, cols,
                                                  queries, plain)
        t = time.perf_counter()
        total[kb.KERNEL_BF16] += dsl_laion(client, svc, vecs, cols, queries,
                                           plain)
        log("timing", step="dsl_laion",
            seconds=f"{time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        search_api_laion(client, node, cols)
        log("timing", step="search_api_laion",
            seconds=f"{time.perf_counter() - t:.1f}")
        drop_index(client, "laion")
    finally:
        server.stop()
    return total


def laion_unfiltered(client, queries):
    """The unfiltered `knn` requests, one binned launch each: their (ids,
    scores) and HTTP latencies."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    dispatch.reset_launches()
    plain, lat = [], []
    for qv in queries:
        t = time.perf_counter()
        plain.append(_hits(client.ok("POST", "/laion/_search",
                                     laion_body(qv))))
        lat.append((time.perf_counter() - t) * 1e3)
    launched = {k: c for k, c in dispatch.launches().items() if c}
    if launched != {kb.KERNEL_BF16: len(queries)}:
        raise AssertionError(f"serve_filtered unfiltered: launches "
                             f"{launched}")
    return plain, lat


# --------------------------------------------------------------- serve_body

BODY_PAGES = 5                  # search_after pages of BODY_PAGE hits
BODY_PAGE = 100
BODY_HIGHLIGHTS = 16            # msmarco `highlight` and RRF bodies
N_MSMARCO_B = 16_384            # the second index of the RRF bodies


class ExactRouteCounter:
    """Counts, while open, the store's `knn_search_auto` calls that carry a
    filter mask: the exact route, which launches no binned kernel."""

    def __init__(self):
        from elasticsearch_tpu_torch.vectors import store as store_mod
        self.ops = store_mod.knn_ops
        self.orig = self.ops.knn_search_auto
        self.calls = 0

        def counting(*args, **kwargs):
            if kwargs.get("filter_mask") is not None:
                self.calls += 1
            return self.orig(*args, **kwargs)

        self.ops.knn_search_auto = counting

    def close(self):
        self.ops.knn_search_auto = self.orig


def body_requests(client, path: str, label: str, bodies, check,
                  binned_each: int, exact: ExactRouteCounter,
                  fields: dict) -> int:
    """Send the bodies one at a time, check each response, and hold the
    binned launches to `binned_each` a request and the exact route to
    none; records the HTTP p50 under `label`. Returns the launches."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    dispatch.reset_launches()
    exact.calls = 0
    lat = []
    for j, body in enumerate(bodies):
        t = time.perf_counter()
        resp = client.ok("POST", path, body)
        lat.append((time.perf_counter() - t) * 1e3)
        check(j, resp)
    launched = {k: c for k, c in dispatch.launches().items() if c}
    want = {kb.KERNEL_BF16: binned_each * len(bodies)} if binned_each \
        else {}
    if launched != want or exact.calls:
        raise AssertionError(f"serve_body {label}: launches {launched}, "
                             f"exact route {exact.calls}; expected {want}")
    fields[f"{label}_p50_ms"] = f"{statistics.median(lat):.3f}"
    fields[f"{label}_launches_a_request"] = binned_each
    return binned_each * len(bodies)


def _expect(label: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"serve_body {label}: {got!r} against "
                             f"{want!r}")


def serve_body_laion(client, svc, cols: dict, queries, plain) -> int:
    """The search body's part on the laion index (1M x 512 of
    serve_filtered): 64 bodies each of `knn` (k 10, num_candidates 100)
    with `sort: [{aesthetic: desc}, {width: asc}]`, with `post_filter`
    (nsfw UNLIKELY), with `min_score` (each query's fifth score), with
    `collapse` on nsfw and `inner_hits` of 2, as `query: {knn}` with a
    `rescore` (aesthetic >= 6.5, weight 2) and with `version`,
    `seq_no_primary_term`, `docvalue_fields` and `explain`: each held to
    the unfiltered answer of its vector (`plain`) reworked on the host
    from `laion_columns` and the engine's versions and seq_nos, one
    binned launch a request and no exact route. Then a `term` query of
    nsfw UNLIKELY sorted by `[{aesthetic: desc}, "_doc"]`: one request of
    500 equal to a numpy lexsort of the column, and BODY_PAGES pages
    through `search_after` equal to it (its HTTP p50 over 5 runs). Logs
    one `body` line; returns the binned launches."""
    nsfw, width = cols["nsfw"], cols["width"]
    aes = cols["aesthetic"].astype(np.float64)
    engine = svc.engine
    fields: dict = {"part": "laion", "requests_a_body": len(queries)}
    exact = ExactRouteCounter()
    launches = 0

    def spec(qi):
        return laion_body(queries[qi])["knn"]

    def ids_of(resp):
        return [int(h["_id"]) for h in resp["hits"]["hits"]]

    try:
        def check_sort(qi, resp):
            ids0 = plain[qi][0]
            want = sorted(ids0, key=lambda i: (-aes[i], width[i], i))
            _expect(f"sort {qi}", ids_of(resp), want)
            _expect(f"sort {qi} sort values",
                    [h["sort"] for h in resp["hits"]["hits"]],
                    [[float(aes[i]), int(width[i])] for i in want])
            _expect(f"sort {qi} scores",
                    [h["_score"] for h in resp["hits"]["hits"]]
                    + [resp["hits"]["max_score"]], [None] * (len(want) + 1))
            _expect(f"sort {qi} total", resp["hits"]["total"],
                    {"value": len(ids0), "relation": "eq"})

        launches += body_requests(
            client, "/laion/_search", "sort",
            [dict(laion_body(q), sort=[{"aesthetic": "desc"},
                                       {"width": "asc"}]) for q in queries],
            check_sort, 1, exact, fields)

        def kept(qi, keep):
            return [(i, s) for i, s in zip(*plain[qi]) if keep(i, s)]

        def check_kept(label, qi, resp, want):
            hits = resp["hits"]
            _expect(f"{label} {qi}", [(int(h["_id"]), h["_score"])
                                      for h in hits["hits"]], want)
            _expect(f"{label} {qi} total", hits["total"],
                    {"value": len(want), "relation": "eq"})
            _expect(f"{label} {qi} max_score", hits["max_score"],
                    want[0][1] if want else None)

        launches += body_requests(
            client, "/laion/_search", "post_filter",
            [dict(laion_body(q), post_filter={"term": {"nsfw": "UNLIKELY"}})
             for q in queries],
            lambda qi, resp: check_kept("post_filter", qi, resp, kept(
                qi, lambda i, s: nsfw[i] == 0)), 1, exact, fields)
        launches += body_requests(
            client, "/laion/_search", "min_score",
            [dict(laion_body(q), min_score=plain[qi][1][4])
             for qi, q in enumerate(queries)],
            lambda qi, resp: check_kept("min_score", qi, resp, kept(
                qi, lambda i, s: s >= plain[qi][1][4])), 1, exact, fields)

        group_rows = {g: np.nonzero(nsfw == g)[0] for g in range(3)}

        def check_collapse(qi, resp):
            seen, want = set(), []
            for i, s in zip(*plain[qi]):
                if nsfw[i] not in seen:
                    seen.add(nsfw[i])
                    want.append((i, s))
            hits = resp["hits"]["hits"]
            _expect(f"collapse {qi}",
                    [(int(h["_id"]), h["_score"]) for h in hits], want)
            for h in hits:
                g = int(nsfw[int(h["_id"])])
                _expect(f"collapse {qi} group", h["fields"],
                        {"nsfw": [str(NSFW_TAGS[g])]})
                # the reference's sub-search: the group's rows, scored
                # 0 by the filter, by row
                inner = h["inner_hits"]["nsfw"]["hits"]
                rows = group_rows[g]
                _expect(f"collapse {qi} inner hits",
                        [(int(x["_id"]), x["_score"])
                         for x in inner["hits"]],
                        [(int(r), 0.0) for r in rows[:2]])
                _expect(f"collapse {qi} inner total", inner["total"],
                        {"value": min(len(rows), 10_000),
                         "relation": "gte" if len(rows) > 10_000
                         else "eq"})

        launches += body_requests(
            client, "/laion/_search", "collapse",
            [dict(laion_body(q), collapse={"field": "nsfw",
                                           "inner_hits": {"size": 2}})
             for q in queries], check_collapse, 1, exact, fields)

        def check_rescore(qi, resp):
            ids0 = np.asarray(plain[qi][0])
            first = np.asarray(plain[qi][1], dtype=np.float32)
            second = np.where(aes[ids0] >= 6.5, np.float32(1.0),
                              np.float32(0.0)).astype(np.float32)
            new = first * np.float32(1.0) + np.float32(2.0) * second
            order = np.lexsort((ids0, -new))
            want = [(int(ids0[j]), float(new[j])) for j in order]
            hits = resp["hits"]
            _expect(f"rescore {qi}", [int(h["_id"]) for h in hits["hits"]],
                    [i for i, _ in want])
            if any(abs(h["_score"] - s) > 1e-6
                   for h, (_, s) in zip(hits["hits"], want)):
                raise AssertionError(f"serve_body rescore {qi}: "
                                     f"{hits['hits']} against {want}")

        launches += body_requests(
            client, "/laion/_search", "rescore",
            [{"query": {"knn": spec(qi)}, "size": 10,
              "_source": LAION_SOURCE,
              "rescore": {"window_size": 10, "query": {
                  "rescore_query": {"range": {"aesthetic": {"gte": 6.5}}},
                  "rescore_query_weight": 2}}}
             for qi in range(len(queries))], check_rescore, 1, exact,
            fields)

        def check_fetch(qi, resp):
            hits = resp["hits"]["hits"]
            _expect(f"fetch {qi}", [(int(h["_id"]), h["_score"])
                                    for h in hits], list(zip(*plain[qi])))
            for h in hits:
                i = int(h["_id"])
                vv = engine.version_map[h["_id"]]
                _expect(f"fetch {qi} doc {i}",
                        (h["_version"], h["_seq_no"], h["_primary_term"],
                         h["fields"], h["_explanation"]),
                        (vv.version, vv.seq_no, 1,
                         {"width": [int(width[i])],
                          "aesthetic": [float(aes[i])]},
                         {"value": h["_score"],
                          "description": "vectorized score",
                          "details": []}))

        launches += body_requests(
            client, "/laion/_search", "fetch",
            [dict(laion_body(q), version=True, seq_no_primary_term=True,
                  docvalue_fields=["width", "aesthetic"], explain=True)
             for q in queries], check_fetch, 1, exact, fields)

        # search_after over the 90% term query, against a numpy lexsort
        rows = np.nonzero(nsfw == 0)[0]
        want = rows[np.lexsort((rows, -aes[rows]))[:BODY_PAGES * BODY_PAGE]]
        body = {"query": {"term": {"nsfw": "UNLIKELY"}},
                "sort": [{"aesthetic": "desc"}, "_doc"],
                "size": BODY_PAGES * BODY_PAGE, "_source": False}

        def check_sorted(_, resp):
            _expect("search_after whole", ids_of(resp), want.tolist())
            _expect("search_after sort values",
                    [h["sort"] for h in resp["hits"]["hits"]],
                    [[float(aes[i]), int(i)] for i in want])

        body_requests(client, "/laion/_search", "sorted_term",
                      [body] * 5, check_sorted, 0, exact, fields)
        pages, after = [], None
        page_body = dict(body, size=BODY_PAGE)
        for _ in range(BODY_PAGES):
            resp = client.ok("POST", "/laion/_search",
                             page_body if after is None
                             else dict(page_body, search_after=after))
            pages += ids_of(resp)
            after = resp["hits"]["hits"][-1]["sort"]
        _expect("search_after pages", pages, want.tolist())
        fields.update(sorted_rows=len(rows), pages=BODY_PAGES,
                      page_size=BODY_PAGE)
        log("body", **fields)
    finally:
        exact.close()
    return launches


def dsl_logs(client, cols: dict, paths: list) -> None:
    """The query DSL on serve_logs' index: `prefix` on `request.raw` and
    `query_string` `status:404 AND request:french`, each total (tracked)
    equal to numpy's over the generated columns (a path's section is its
    number mod 5; french is 1) and its page in row order. Logs one `[dsl]
    part=logs` line."""
    fields: dict = {"part": "logs", "docs": len(cols["path"]),
                    "requests_a_body": DSL_REQUESTS}
    prefix = "GET /french/1"
    starts = np.asarray([f"GET {p}".startswith(prefix) for p in paths])
    wants = {
        "prefix_raw": ({"prefix": {"request.raw": prefix}},
                       np.nonzero(starts[cols["path"]])[0]),
        "qs_status": ({"query_string": {
            "query": "status:404 AND request:french"}},
            np.nonzero((cols["status"] == 404)
                       & (cols["path"] % 5 == 1))[0]),
    }
    for label, (query, rows) in wants.items():
        resp = dsl_timed(client, "/logs/_search", label, {
            "query": query, "size": 10, "track_total_hits": True,
            "_source": False}, fields)
        hits = resp["hits"]
        if hits["total"] != {"value": len(rows), "relation": "eq"} \
                or [int(h["_id"]) for h in hits["hits"]] \
                != rows[:10].tolist():
            raise AssertionError(f"[dsl] logs {label}: {hits['total']} "
                                 f"{[h['_id'] for h in hits['hits']]}, "
                                 f"numpy {len(rows)} {rows[:10]}")
        fields[f"{label}_total"] = len(rows)
    log("dsl", **fields)


LAION_COSINE = "cosineSimilarity(params.query_vector, 'vec') + 1.0"
LAION_STATEMENT = ("double c = cosineSimilarity(params.query_vector, 'vec');"
                   " if (doc['aesthetic'].value >= 6.5) { c += 1; }"
                   " for (int i = 0; i < 2; i++) { c += 0.5; } return c;")
LAION_TEMPLATE = ('{"knn": {"field": "vec", "query_vector": '
                  '{{#toJson}}qv{{/toJson}}, "k": 10, "num_candidates": '
                  '100}, "size": 10, "_source": false}')


def _f64_cosine(vecs: np.ndarray, rows: np.ndarray,
                qv: np.ndarray) -> np.ndarray:
    m = vecs[rows].astype(np.float64)
    q = qv.astype(np.float64)
    return (m @ q) / (np.linalg.norm(m, axis=1) * np.linalg.norm(q))


def dsl_laion(client, svc, vecs, cols, queries, plain) -> int:
    """Scripts on laion (serve_filtered's 1M x 512 index): `script_score`
    with `cosineSimilarity(params.query_vector, 'vec') + 1.0` over the
    aesthetic_gte_6_5 filter, ES 7.x's brute-force kNN, each top 10
    against an f64 numpy cosine over the filter's rows (recall@10 1.0,
    ties within 1e-5 counted, scores within 1e-5), timed beside the same
    filter as a `knn` filter (the exact route: its calls counted); the
    same script stored (`_scripts/{id}`) and used by id; a Painless
    statement (`if`, `for`) scoring a `knn` clause's hits, against its
    numpy value; `script_fields` on `knn` bodies; and a `_search/template`
    rendering a `knn` body. Every kNN-bearing body held to the unfiltered
    answer of its vector (`plain`) and launching the bf16 binned kernel
    once; the filtered scripts none. Logs one `[dsl] part=laion` line;
    returns the binned launches."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    aes = cols["aesthetic"]
    rows = np.nonzero(aes >= 6.5)[0]
    filt = {"range": {"aesthetic": {"gte": 6.5}}}
    qs = queries[:DSL_REQUESTS]
    fields: dict = {"part": "laion", "filter_rows": len(rows),
                    "requests_a_body": len(qs)}
    exact = ExactRouteCounter()
    launches = 0

    def run(label, bodies, check, binned_each):
        return body_requests(client, "/laion/_search", label, bodies, check,
                             binned_each, exact, fields)

    def check_brute(label, shift):
        def check(j, resp):
            f64 = _f64_cosine(vecs, rows, qs[j]) + shift
            order = np.lexsort((rows, -f64))
            tenth = f64[order[9]]
            want = set(rows[order[:10]].tolist())
            hits = resp["hits"]["hits"]
            for h in hits:
                i = int(h["_id"])
                at = np.searchsorted(rows, i)
                if at >= len(rows) or rows[at] != i:
                    raise AssertionError(f"[dsl] {label} {j}: {i} outside "
                                         f"the filter")
                if abs(h["_score"] - f64[at]) > 1e-5:
                    raise AssertionError(f"[dsl] {label} {j}: {i} scored "
                                         f"{h['_score']}, f64 {f64[at]}")
                if i not in want and f64[at] < tenth - 1e-5:
                    raise AssertionError(f"[dsl] {label} {j}: {i} not in "
                                         f"the f64 top 10")
            if len(hits) != 10 or resp["hits"]["total"]["value"] \
                    != min(len(rows), 10_000):
                raise AssertionError(f"[dsl] {label} {j}: {resp['hits']}")
            _page_in_order(f"{label} {j}", hits)
        return check

    try:
        launches += run("script_score", [
            {"query": {"script_score": {"query": {"bool": {
                "filter": [filt]}}, "script": {
                "source": LAION_COSINE,
                "params": {"query_vector": q.tolist()}}}},
             "size": 10, "_source": False} for q in qs],
            check_brute("script_score", 1.0), 0)
        # the same filter as a `knn` filter: the exact route, no launch
        dispatch.reset_launches()
        exact.calls = 0
        lat = []
        for j, q in enumerate(qs):
            t = time.perf_counter()
            ids, _ = _hits(client.ok("POST", "/laion/_search",
                                     laion_body(q, filt)))
            lat.append((time.perf_counter() - t) * 1e3)
            if len(ids) != 10 or not np.isin(ids, rows).all():
                raise AssertionError(f"[dsl] knn+filter {j}: {ids}")
        if exact.calls != len(qs) or any(dispatch.launches().values()):
            raise AssertionError(f"[dsl] knn+filter: {exact.calls} exact "
                                 f"route calls, {dispatch.launches()}")
        fields["knn_filter_p50_ms"] = f"{statistics.median(lat):.3f}"
        fields["knn_filter_exact_route_calls"] = exact.calls
        client.ok("PUT", "/_scripts/laion_cos", {"script": {
            "lang": "painless", "source":
                "cosineSimilarity(params.query_vector, 'vec') "
                "+ params.shift"}})
        launches += run("stored_script", [
            {"query": {"script_score": {"query": {"bool": {
                "filter": [filt]}}, "script": {"id": "laion_cos", "params": {
                    "query_vector": q.tolist(), "shift": 2.0}}}},
             "size": 10, "_source": False} for q in qs],
            check_brute("stored_script", 2.0), 0)
        client.ok("DELETE", "/_scripts/laion_cos")

        def check_statement(j, resp):
            ids0 = np.asarray(plain[j][0])
            f64 = _f64_cosine(vecs, ids0, qs[j]) \
                + (aes[ids0] >= 6.5) + 1.0
            order = np.lexsort((ids0, -f64))
            hits = resp["hits"]["hits"]
            got = [int(h["_id"]) for h in hits]
            if sorted(got) != sorted(ids0.tolist()) or any(
                    abs(h["_score"] - f64[list(ids0).index(int(h["_id"]))])
                    > 1e-5 for h in hits):
                raise AssertionError(f"[dsl] statement {j}: {hits} against "
                                     f"{ids0[order]} {f64[order]}")
            _page_in_order(f"statement {j}", hits)

        launches += run("statement", [
            {"query": {"script_score": {
                "query": {"knn": laion_body(q)["knn"]},
                "script": {"source": LAION_STATEMENT,
                           "params": {"query_vector": q.tolist()}}}},
             "size": 10, "_source": False} for q in qs],
            check_statement, 1)

        def check_fields(j, resp):
            hits = resp["hits"]["hits"]
            if _hits(resp) != (plain[j][0], plain[j][1]):
                raise AssertionError(f"[dsl] script_fields {j}: hits")
            for h in hits:
                i = int(h["_id"])
                cos = float(_f64_cosine(vecs, np.asarray([i]), qs[j])[0])
                want = float(np.float32(np.float64(aes[i]) * 2))
                if abs(h["fields"]["cos"][0] - cos) > 1e-5 \
                        or h["fields"]["aes2"] != [want]:
                    raise AssertionError(f"[dsl] script_fields {j}: "
                                         f"{h['fields']}, {cos} {want}")

        launches += run("script_fields", [
            dict(laion_body(q), script_fields={
                "cos": {"script": {"source": "cosineSimilarity(params.q, "
                                             "'vec')",
                                   "params": {"q": q.tolist()}}},
                "aes2": {"script": "doc['aesthetic'].value * 2"}})
            for q in qs], check_fields, 1)

        dispatch.reset_launches()
        lat = []
        for j, q in enumerate(qs):
            t = time.perf_counter()
            resp = client.ok("POST", "/laion/_search/template", {
                "source": LAION_TEMPLATE, "params": {"qv": q.tolist()}})
            lat.append((time.perf_counter() - t) * 1e3)
            if _hits(resp) != (plain[j][0], plain[j][1]):
                raise AssertionError(f"[dsl] template {j}: {_hits(resp)}")
        if dispatch.launches().get(kb.KERNEL_BF16, 0) != len(qs):
            raise AssertionError(f"[dsl] template: {dispatch.launches()}")
        launches += len(qs)
        fields["template_p50_ms"] = f"{statistics.median(lat):.3f}"
    finally:
        exact.close()
    log("dsl", **fields)
    return launches


def dsl_sift(client, node, rng, queries, deleted: set, updated: dict,
             live_of) -> int:
    """`_update` scripts on sift (serve_documents' index, after its
    generations' gates): 64 `ctx._source.tag = params.t`, then a `+=` on
    each; 8 scripts that rewrite the vector; 16 `ctx.op = 'delete'`; a
    refresh. Then `_count` of the tags, each rewritten vector's id first
    for its new vector, no deleted id in the 64 queries' kNN answers, and
    recall@10 >= 0.95 against exact f32 numpy over the live rows; every
    request served by the bf16 binned kernel or the exact legs of the
    tombstoned generations. Logs one `[dsl] part=sift` line; returns the
    binned launches."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    names, _ = live_of()
    plain_names = [nm for nm in names if nm.isdigit() and nm not in updated]
    pick = rng.choice(len(plain_names), 88, replace=False)
    tagged = [plain_names[i] for i in pick[:64]]
    rewritten = [plain_names[i] for i in pick[64:72]]
    victims = [plain_names[i] for i in pick[72:]]
    fresh = clustered(rng, len(rewritten), 128)
    fields: dict = {"part": "sift"}
    lat = []

    def update(doc_id, script, result):
        t = time.perf_counter()
        resp = client.ok("POST", f"/sift/_update/{doc_id}",
                         {"script": script})
        lat.append((time.perf_counter() - t) * 1e3)
        if resp["result"] != result:
            raise AssertionError(f"[dsl] sift update {doc_id}: {resp}")

    for j, doc_id in enumerate(tagged):
        update(doc_id, {"source": "ctx._source.tag = params.t",
                        "params": {"t": f"t{j}"}}, "updated")
    for doc_id in tagged:
        update(doc_id, {"source": "ctx._source.tag += params.s",
                        "params": {"s": "-x"}}, "updated")
    for doc_id, v in zip(rewritten, fresh):
        update(doc_id, {"source": "ctx._source.vec = params.v",
                        "params": {"v": v.tolist()}}, "updated")
        updated[doc_id] = v
    for doc_id in victims:
        update(doc_id, {"source": "ctx.op = 'delete'"}, "deleted")
        deleted.add(doc_id)
    fields["update_scripts"] = len(lat)
    fields["update_p50_ms"] = f"{statistics.median(lat):.3f}"
    client.ok("POST", "/sift/_refresh")
    count = client.ok("POST", "/sift/_count", {"query": {
        "prefix": {"tag.keyword": "t"}}})["count"]
    doc = client.ok("GET", f"/sift/_doc/{tagged[5]}")["_source"]
    if count != len(tagged) or doc.get("tag") != "t5-x":
        raise AssertionError(f"[dsl] sift tags: count {count}, {doc}")
    svc = node.index("sift")
    stats0 = dict(svc.store.knn_stats)
    dispatch.reset_launches()
    for doc_id in rewritten:
        hits = client.ok("POST", "/sift/_search", knn_body(
            "vec", updated[doc_id]))["hits"]["hits"]
        if hits[0]["_id"] != doc_id:
            raise AssertionError(f"[dsl] sift rewritten {doc_id}: first "
                                 f"hit {hits[0]['_id']}")
    names, live = live_of()
    truth = exact_top(live, queries, 10, "cosine")
    recalls, knn_lat = [], []
    for qi, qv in enumerate(queries):
        t = time.perf_counter()
        hits = client.ok("POST", "/sift/_search",
                         knn_body("vec", qv))["hits"]["hits"]
        knn_lat.append((time.perf_counter() - t) * 1e3)
        ids = {h["_id"] for h in hits}
        if ids & deleted:
            raise AssertionError(f"[dsl] sift query {qi}: deleted ids "
                                 f"{ids & deleted}")
        recalls.append(len(ids & {names[r] for r in truth[qi].tolist()})
                       / 10)
    recall = float(np.mean(recalls))
    if recall < 0.95:
        raise AssertionError(f"[dsl] sift recall@10 {recall} < 0.95")
    n_req = len(rewritten) + len(queries)
    binned = dispatch.launches().get(kb.KERNEL_BF16, 0)
    exact_legs, kernel_legs, gens, _ = _leg_counts(svc, stats0)
    if binned + exact_legs + kernel_legs < n_req:
        raise AssertionError(f"[dsl] sift: {binned} binned launches, "
                             f"{exact_legs} exact and {kernel_legs} kernel "
                             f"legs for {n_req} requests")
    fields.update(knn_requests=n_req, recall_at_10=recall,
                  knn_p50_ms=f"{statistics.median(knn_lat):.3f}",
                  binned_launches=binned, exact_legs=exact_legs,
                  kernel_legs=kernel_legs, generations=gens,
                  deleted_by_script=len(victims))
    log("dsl", **fields)
    return binned


class RunningTop:
    """Exact f32 top-k of a query batch over row chunks seen one at a time
    (cosine: rows and queries L2-normalized), so the recall oracle never
    holds the whole corpus; `update(block, first_row, keep)` takes the
    rows first_row.. of the corpus, `keep` masking rows out."""

    def __init__(self, queries: np.ndarray, k: int):
        self.q = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        self.k = k
        self.scores = np.full((len(queries), k), -np.inf, dtype=np.float32)
        self.rows = np.full((len(queries), k), -1, dtype=np.int64)

    def update(self, block: np.ndarray, first_row: int, keep=None) -> None:
        rows = np.arange(first_row, first_row + len(block), dtype=np.int64)
        if keep is not None:
            block, rows = block[keep], rows[keep]
        if not len(rows):
            return
        s = self.q @ (block / np.linalg.norm(block, axis=1,
                                             keepdims=True)).T
        k = min(self.k, len(rows))
        top = np.argpartition(-s, k - 1, axis=1)[:, :k]
        s2 = np.concatenate([self.scores, np.take_along_axis(s, top, 1)], 1)
        r2 = np.concatenate([self.rows, rows[top]], 1)
        sel = np.argsort(-s2, axis=1, kind="stable")[:, :self.k]
        self.scores = np.take_along_axis(s2, sel, 1)
        self.rows = np.take_along_axis(r2, sel, 1)


SHARDS = 8
SHARDED_CHUNK = 1 << 18
# Murmur3HashFunctionTests.java's known values of the routing hash
KNOWN_MURMUR3 = {
    "hell": 0x5A0CB7C3, "hello": 0xD7C31989, "hello w": 0x22AB2984,
    "hello wo": 0xDF0CA123, "hello wor": 0xE7744D61,
    "The quick brown fox jumps over the lazy dog": 0xE07DB09C,
    "The quick brown fox jumps over the lazy cog": 0x4E63D2AD,
}
# the shard of 8 that the reference (`elasticsearch_tpu/cluster/routing.py`)
# gives these `_id`s of serve_sharded's corpus and these routing values
REF_SHARD_OF_8 = {
    "0": 0, "1": 3, "2": 3, "3": 2, "4": 3, "5": 7, "6": 1, "7": 6, "8": 2,
    "9": 2, "10": 7, "11": 3, "12": 6, "13": 5, "14": 2, "15": 3,
    "1000": 3, "124457": 6, "247914": 1, "371371": 7, "494828": 0,
    "618285": 3, "741742": 2, "865199": 5, "988656": 5, "1112113": 7,
    "1235570": 4, "1359027": 0, "1482484": 6, "1605941": 2, "1729398": 3,
    "1852855": 2,
    "user0": 2, "user1": 4, "user2": 5, "user3": 4, "user4": 4,
}
# BASELINE config 4 is Cohere-Wiki-10M: cut to 1M for the run's time, which
# serve_hybrid and serve_sparse share (PERF.md section 4; ~10 GB of host
# memory a million rows)
N_SHARDED = 1_000_000


def sharded_chunks(seed: int, n: int, dev):
    """Cohere-shaped 768-d rows, ~64 a cluster in each shard (the
    cohere_ivf phase's shape at one shard, so ~64 * SHARDS a cluster over
    the corpus: a shard's own top 10 then lies in the query's cluster, as
    at one shard), made on `dev` from `seed` and yielded to the host as
    (first row, [m, 768] block) chunks of SHARDED_CHUNK rows, so no copy
    of the whole corpus is ever held beside the index."""
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    n_centers = max(n // (64 * SHARDS), 1)
    centers = torch.randn(n_centers, 768, generator=g, device=dev) * 2.0
    for lo in range(0, n, SHARDED_CHUNK):
        m = min(SHARDED_CHUNK, n - lo)
        assign = torch.randint(0, n_centers, (m,), generator=g, device=dev)
        yield lo, (centers[assign] + torch.randn(
            m, 768, generator=g, device=dev)).cpu().numpy()


def sharded_grp(i: np.ndarray) -> list:
    """The filter column: `grp: a` on every 64th doc, `b` 32 docs later,
    no field elsewhere."""
    return [{"grp": "a"} if j % 64 == 0 else {"grp": "b"} if j % 64 == 32
            else None for j in i.tolist()]


def phase_serve_sharded(seed: int, n: int, device: str = "cuda",
                        smi: str = "", one_shard=None) -> dict:
    """serve_sharded: BASELINE config 4 (Cohere-Wiki 768-d, int8 quantized
    kNN, 8 shards), cut from 10M to `n` rows (N_SHARDED). An
    8-shard `int8_ivf` index on the card: 1,000 docs over `_bulk`, the
    rest through `IndexService.index_many` (each id to its shard by
    murmur3, as `_bulk` routes it), one refresh. Gates: the routing hash
    gives KNOWN_MURMUR3, the ids of REF_SHARD_OF_8 lie in the reference's
    shards, every shard holds as many docs as ids hash to it; 64
    sequential `_search {knn}` requests over HTTP reach recall@10 >= 0.90
    against exact f32 numpy over the whole corpus and routing recall >=
    0.95 (against every shard probed in full), no shard's tuned nprobe
    above half its nlist (else the cell measures a scan), each launching `ivf_fused_dense/grouped` once a shard and no
    other kernel, with `_shards.total` 8; a filtered request (`grp: a`,
    1/64 of the docs, on every shard) keeps its hits inside the filter at
    recall@10 >= 0.95 against exact f32 over the passing rows; 16
    `GET _doc/{id}?routing=` find documents indexed with that routing;
    closed-loop clients at C = 1 and 8 get their batch-1 answers (ties
    counted), no 429 and no error, one launch a shard a batch. Logs
    ingest, HTTP and store p50, QPS and p99 a level, each shard's router
    phases and launches a request, beside the one-shard `int8_ivf` index
    of serve_cohere_ivf (`one_shard`) and the card. Returns the launches."""
    from elasticsearch_tpu_torch.cluster.routing import (
        hash_routing, shard_ids_for)
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import ivf_fused as fused
    from elasticsearch_tpu_torch.server import build_server
    dev = torch.device(device)
    name, kernel = "cohere8", fused.KERNEL_DENSE
    card = json.dumps(smi)
    node, server = build_server(device=device, port=0,
                                settings=SERVE_SETTINGS)
    server.start()
    timer = IvfBuildTimer()
    total = {kernel: 0}
    try:
        client = Client(server.port)
        client.ok("PUT", f"/{name}", {
            "settings": {"number_of_shards": SHARDS,
                         "index.knn.engine": "tpu_ivf"},
            "mappings": {"_source": {"enabled": False}, "properties": {
                "vec": {"type": "dense_vector", "dims": 768,
                        "similarity": "cosine",
                        "index_options": {"type": "int8_ivf"}},
                "grp": {"type": "keyword"}}}})
        svc = node.index(name)
        first = min(1000, n)
        clock = {"data": 0.0, "truth": 0.0, "ingest": 0.0}
        oracle = {}

        def on_chunk(lo, block):
            t = time.perf_counter()
            ids = np.arange(lo, lo + len(block))
            oracle["all"].update(block, lo)
            oracle["grp_a"].update(block, lo, ids % 64 == 0)
            clock["truth"] += time.perf_counter() - t
            t = time.perf_counter()
            cut = max(first - lo, 0)
            if cut:
                ops = []
                for i, src in zip(range(lo, lo + cut),
                                  sharded_grp(ids[:cut])):
                    ops += [{"index": {"_id": str(i)}},
                            dict(src or {}, vec=block[i - lo].tolist())]
                if client.ok("POST", f"/{name}/_bulk", ops,
                              ndjson=True)["errors"]:
                    raise AssertionError("serve_sharded: bulk errors")
            if len(block) > cut:
                svc.index_many([str(i) for i in ids[cut:].tolist()],
                               sources=sharded_grp(ids[cut:]),
                               vectors={"vec": block[cut:]})
            clock["ingest"] += time.perf_counter() - t

        # the 64 queries: rows of the first chunk (random draws like any
        # others) plus 0.3 noise; the oracles then see every chunk
        chunks = sharded_chunks(seed, n, dev)
        t0 = time.perf_counter()
        lo, block = next(chunks)
        rng = np.random.default_rng(seed + 5)
        queries = block[rng.integers(0, len(block), 64)] \
            + 0.3 * rng.standard_normal((64, 768), dtype=np.float32)
        oracle["all"] = RunningTop(queries, 10)
        oracle["grp_a"] = RunningTop(queries[:1], 10)
        while block is not None:
            clock["data"] += time.perf_counter() - t0
            on_chunk(lo, block)
            t0 = time.perf_counter()
            lo, block = next(chunks, (None, None))
        del block
        t = time.perf_counter()
        client.ok("POST", f"/{name}/_refresh")
        clock["ingest"] += time.perf_counter() - t
        truth, truth_a = oracle["all"].rows, oracle["grp_a"].rows[0]

        # routing: the port's murmur3 gives Murmur3HashFunctionTests' values;
        # each sampled id lies in the shard the reference names, and in no
        # other; each shard holds as many docs as ids hash to it
        hashes = {t: hash_routing(t) & 0xFFFFFFFF for t in KNOWN_MURMUR3}
        if hashes != KNOWN_MURMUR3:
            raise AssertionError(f"serve_sharded murmur3 {hashes}")
        for doc_id, want_shard in REF_SHARD_OF_8.items():
            held = [s.shard_id for s in svc.shards
                    if doc_id in s.engine.version_map]
            if doc_id.isdigit() and int(doc_id) < n and held != [want_shard]:
                raise AssertionError(f"serve_sharded: doc {doc_id} in "
                                     f"shards {held}, the reference's is "
                                     f"{want_shard}")
        want = np.bincount(shard_ids_for([str(i) for i in range(n)],
                                         SHARDS), minlength=SHARDS)
        got = [s.engine.acquire_searcher().num_docs for s in svc.shards]
        if got != want.tolist():
            raise AssertionError(f"serve_sharded: shard doc counts {got}, "
                                 f"murmur3 gives {want.tolist()}")
        t = time.perf_counter()
        client.ok("POST", f"/{name}/_search", knn_body("vec", queries[0]))
        warmup_s = time.perf_counter() - t

        stores = [s.vector_store for s in svc.shards]
        stats0 = [dict(st.knn_stats) for st in stores]
        dispatch.reset_launches()
        lat, hits, scores = [], [], []
        for qv in queries:
            t = time.perf_counter()
            resp = client.ok("POST", f"/{name}/_search", knn_body("vec", qv))
            lat.append((time.perf_counter() - t) * 1e3)
            if resp["_shards"]["total"] != SHARDS \
                    or resp["_shards"]["successful"] != SHARDS:
                raise AssertionError(f"serve_sharded _shards "
                                     f"{resp['_shards']}")
            ids, sc = _hits(resp)
            if len(ids) != 10 or not all(map(np.isfinite, sc)):
                raise AssertionError(f"serve_sharded bad hits {resp['hits']}")
            hits.append(ids)
            scores.append(sc)
        launches = {k: c for k, c in dispatch.launches().items() if c}
        variants = {k: c for k, c in dispatch.variant_launches().items()
                    if c}
        want_launches = len(queries) * SHARDS
        if launches != {kernel: want_launches} or variants != {
                f"{kernel}/{fused.VARIANT_GROUPED}": want_launches}:
            raise AssertionError(f"serve_sharded launches {launches} "
                                 f"{variants}; expected {want_launches} "
                                 f"grouped {kernel}")
        total[kernel] += want_launches
        deltas = [{k: st.knn_stats[k] - s0[k] for k in s0}
                  for st, s0 in zip(stores, stats0)]
        for d in deltas:
            if (d["ivf_searches"], d["fallback_searches"],
                    d["fused_probe_searches"]) != (64, 0, 64):
                raise AssertionError(f"serve_sharded shard stats {d}")
        recall = float(np.mean([len(set(h) & set(t.tolist())) / 10
                                for h, t in zip(hits, truth)]))

        # routing recall: the tuned probing against every shard probed in
        # full, merged across shards
        reader = svc.combined_reader()
        from elasticsearch_tpu_torch.indices.service import SHARD_ROW_SPACE
        full_s, full_r = [], []
        for shard, st in zip(svc.shards, stores):
            fc = st.field("vec")
            sc, rows, _ = fc.router.search(queries, 10,
                                           nprobe=fc.router.index.nlist)
            valid = rows >= 0
            g = np.where(valid, fc.row_map[np.where(valid, rows, 0)]
                         + shard.shard_id * SHARD_ROW_SPACE, -1)
            full_s.append(np.where(valid, sc, -np.inf))
            full_r.append(g)
        full_s, full_r = np.concatenate(full_s, 1), np.concatenate(full_r, 1)
        order = np.argsort(-full_s, axis=1, kind="stable")[:, :10]
        full = [{int(reader.get_id(int(r))) for r in row if r >= 0}
                for row in np.take_along_axis(full_r, order, 1)]
        routing_recall = float(np.mean([len(set(h) & f) / 10
                                        for h, f in zip(hits, full)]))

        # the tuned probe count of each shard: a shard probing more than
        # half its lists is close to a scan, and the cell would not measure
        # IVF over shards
        nprobes = [st.field("vec").router.effective_nprobe(10)
                   for st in stores]
        nlists = [st.field("vec").router.index.nlist for st in stores]
        multi = svc.vector_store
        store_lat = []
        for qv in queries:
            t = time.perf_counter()
            multi.search("vec", qv, 10)
            store_lat.append((time.perf_counter() - t) * 1e3)
        fc0 = stores[0].field("vec")
        fields = dict(
            docs=n, shards=SHARDS, dims=768, requests=len(queries),
            shard_docs=json.dumps(got), nlist=json.dumps(
                [st.field("vec").router.index.nlist for st in stores]),
            nprobe=json.dumps(nprobes),
            cap=fc0.router.index.cap,
            data_s=f"{clock['data']:.2f}", truth_s=f"{clock['truth']:.2f}",
            ingest_s=f"{clock['ingest']:.2f}",
            ingest_s_per_million=f"{clock['ingest'] / n * 1e6:.2f}",
            ivf_train_s=f"{timer.seconds['train']:.2f}",
            ivf_place_s=f"{timer.seconds['place']:.2f}",
            ivf_upload_s=f"{timer.seconds['upload']:.2f}",
            warmup_s=f"{warmup_s:.3f}",
            p50_ms=f"{statistics.median(lat):.3f}",
            store_p50_ms=f"{statistics.median(store_lat):.3f}",
            recall_at_10=recall, routing_recall_at_10=routing_recall,
            launches_per_request=want_launches / len(queries),
            launches=json.dumps(launches))
        # each shard's router phases (after a device sync each), a request
        for phase in ("route", "score", "merge"):
            fields[f"shard_{phase}_ms"] = json.dumps(
                [round(d[f"{phase}_nanos"] / 64 / 1e6, 4) for d in deltas])
        if dev.type == "cuda":
            fields["device_peak_gb"] = \
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f}"
        fields["host_peak_rss_gb"] = (f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9:.2f}")
        for key, v in (one_shard or {}).items():
            fields[f"one_shard_{key}"] = v
        log("serve_sharded", **fields, card=card)
        if recall < 0.90 or routing_recall < 0.95:
            raise AssertionError(f"serve_sharded recall@10 {recall} (gate "
                                 f"0.90), routing {routing_recall} (0.95)")
        if any(2 * p > nl for p, nl in zip(nprobes, nlists)):
            raise AssertionError(f"serve_sharded nprobe {nprobes} of nlist "
                                 f"{nlists}: a shard scans over half its "
                                 f"lists")

        # one filtered request: grp a passes rows on every shard
        body = {"knn": {"field": "vec", "query_vector": queries[0].tolist(),
                        "k": 10, "num_candidates": 100,
                        "filter": {"term": {"grp": "a"}}}, "size": 10}
        dispatch.reset_launches()
        t = time.perf_counter()
        ids, _ = _hits(client.ok("POST", f"/{name}/_search", body))
        filtered_ms = (time.perf_counter() - t) * 1e3
        launched = {k: c for k, c in dispatch.launches().items() if c}
        node.search(name, body)     # this thread's phases, shard by shard
        reasons = {st.last_knn_phases.get("fallback_reason")
                   for st in stores}
        f_recall = len(set(ids) & set(truth_a.tolist())) / 10
        log("serve_sharded", filtered_request_ms=f"{filtered_ms:.3f}",
            filter_rows=len(range(0, n, 64)), recall_at_10=f_recall,
            fallback_reasons=json.dumps(sorted(map(str, reasons))),
            card=card)
        if len(ids) != 10 or any(i % 64 for i in ids) or f_recall < 0.95 \
                or launched or reasons != {"filtered"}:
            raise AssertionError(f"serve_sharded filtered: hits {ids}, "
                                 f"recall {f_recall}, launches {launched}, "
                                 f"fallback {reasons}")

        # GET by routing: documents indexed with a routing value
        for j in range(16):
            route = f"user{j % 5}"
            client.ok("PUT", f"/{name}/_doc/routed{j}?routing={route}",
                      {"grp": "routed"})
            doc = client.ok("GET", f"/{name}/_doc/routed{j}?routing={route}")
            shard = svc.shards[REF_SHARD_OF_8[route]]
            if not doc["found"] or doc.get("_routing") != route \
                    or f"routed{j}" not in shard.engine.version_map:
                raise AssertionError(f"serve_sharded GET routed{j}: {doc}")
        log("serve_sharded", get_by_routing=16, card=card)

        # concurrent clients: the index's batcher coalesces them, one
        # launch a shard a batch
        extra = {"hits": hits, "scores": scores, "truth": truth}
        before = multi.scheduler_stats()
        conc = serve_concurrent(
            name, server.port, f"/{name}/_search",
            [knn_body("vec", qv) for qv in queries], (1, 8),
            CONCURRENT_REQUESTS, knn_against_batch1(
                name, extra, lambda sc: 1e-5 * max(1.0, max(map(abs, sc)))),
            multi.scheduler_stats, (multi, "_dispatch_batch", 0),
            {f"{kernel}/{fused.VARIANT_GROUPED}"}, truth=truth,
            recall=recall)
        batches = multi.scheduler_stats()["batches"] - before.get(
            "batches", 0)
        if conc.get(kernel, 0) != SHARDS * batches:
            raise AssertionError(f"serve_sharded concurrent: {conc} "
                                 f"launches for {batches} batches of "
                                 f"{SHARDS} shards")
        total[kernel] += conc.get(kernel, 0)
        log("serve_sharded", concurrent_batches=batches,
            launches_per_batch=SHARDS, card=card)
        drop_index(client, name)
    finally:
        timer.close()
        server.stop()
    return total


# ------------------------------------------------------------ bm25 kernel

# MS MARCO passage-ranking shape: 8,841,823 passages of about 56 words
# (collection.tsv) and dev queries of about 6; a Zipf (s = 1.0) vocabulary
# of 200,000 words stands in for the text. Cut to 262,144 passages for
# the run's time: ingest on the host takes ~170 us a passage (PERF.md
# section 4). The bm25_board kernel cases run on a layout of as many docs.
MSMARCO_VOCAB = 200_000
MSMARCO_WORDS = (20, 93)       # passage words, uniform: a mean of 56
MSMARCO_QUERY_WORDS = 6
N_MSMARCO = 1 << 18
MSMARCO_CHUNK = 1 << 16
BM25_WINDOW = 100               # the RRF leg's window (rank_window_size)


def zipf_cdf(v: int = MSMARCO_VOCAB, s: float = 1.0) -> np.ndarray:
    p = 1.0 / np.arange(1, v + 1, dtype=np.float64) ** s
    return np.cumsum(p / p.sum())


def _bm25_field(g, dev, dtype: str, n_slots: int, ranks, rng):
    """A LexicalField over a synthetic impact layout: Zipf rank r's word
    `w<r>` in about n_slots * (1 - exp(-56 p_r)) random docs (its share
    of 56-word passages), impacts uniform in [0.05, 8); the tiles of every
    rank in `ranks` (each term's run padded to whole 128-lane tiles, as
    `LexicalField._install_tiles` lays them out)."""
    from elasticsearch_tpu_torch.ops import bm25
    p = np.diff(np.concatenate([[0.0], zipf_cdf()]))
    spans, slot_parts, tile = {}, [], 0
    for r in sorted(set(int(x) for x in ranks)):
        df = max(int(round(n_slots * -np.expm1(-56.0 * p[r]))), 1)
        slots = torch.randperm(n_slots, generator=g, device=dev)[:df]
        nt = -(-df // bm25.TILE)
        pad = torch.full((nt * bm25.TILE,), -1, dtype=torch.int32, device=dev)
        pad[:df] = torch.sort(slots).values.to(torch.int32)
        slot_parts.append(pad)
        spans[f"w{r}"] = (tile, nt)
        tile += nt
    slots = torch.cat(slot_parts).reshape(-1, bm25.TILE)
    lf = bm25.LexicalField("body", dtype, device=dev)
    lf.n_slots, lf.row_map = n_slots, np.arange(n_slots, dtype=np.int64)
    lf.term_tiles, lf.version = spans, ("synthetic", dtype)
    lf.tile_slots = slots.cpu().numpy()
    lf.tile_first = np.ascontiguousarray(lf.tile_slots[:, 0])
    lf.tile_impacts = np.where(
        lf.tile_slots >= 0,
        rng.uniform(0.05, 8.0, lf.tile_slots.shape), 0.0).astype(np.float32)
    lf.nnz = int((lf.tile_slots >= 0).sum())
    return lf


def _bm25_queries(rng, nq: int):
    """nq queries of 6 Zipf-drawn words: query 0 repeats a word, query 1
    adds an out-of-vocabulary one, query 2 has no word in the vocabulary,
    queries 3 and 4 require 2 and 3 matches."""
    cdf = zipf_cdf()
    ranks = np.searchsorted(cdf, rng.random((nq, MSMARCO_QUERY_WORDS)))
    ranks = np.minimum(ranks, MSMARCO_VOCAB - 1)
    queries = [[f"w{r}" for r in row] for row in ranks]
    queries[0].append(queries[0][1])
    if nq > 2:
        queries[1].insert(2, "oovword")
        queries[2] = ["oovword", "unseen"]
    required = np.ones(nq, dtype=np.int32)
    required[3], required[4] = 2, 3
    return [(q, 1.0 + 0.5 * (i % 3)) for i, q in enumerate(queries)], \
        required, ranks


def _bm25_args(lf, queries, required):
    """`bm25_board`'s arguments up to k for a batch, on the field's card."""
    from elasticsearch_tpu_torch.ops import bm25
    dev = lf.device
    pos_starts, runs = lf.plan_positions(queries)
    bm25.check_plan(pos_starts, runs, len(lf.tile_slots))
    return (torch.from_numpy(pos_starts).to(dev), torch.from_numpy(runs).to(dev),
            torch.from_numpy(np.asarray(required, dtype=np.int32)).to(dev),
            lf._device_tile_first(), *lf._device_arrays())


def _same_board_window(got, want, label: str) -> None:
    """The window bit for bit: f32 bits of the finite prefix and its slots,
    -inf and -1 past it."""
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1])
            and bool(((got[1] == -1) == torch.isneginf(got[0])).all())):
        bad = int((got[1] != want[1]).sum())
        raise AssertionError(f"bm25_board {label}: differs from its plain "
                             f"version ({bad} window slots)")


# the device symbols of bm25_board's two kernels (csrc/bm25.cu): kernel A,
# kernel B
BM25_KERNEL_SYMBOLS = ("board_select_kernel", "merge_kernel")


def _bm25_case(lf, queries, required, label: str, timed: bool,
               range_slots=None) -> dict:
    """bm25_board (its two kernels) against its plain version on the card,
    the window bit for bit, one call counted; at f32 the board route
    against the host twin; with `timed`, CUDA-event ms of a call and a
    burst, the plain version's, the yardstick's (one index_put_ pair into
    zeroed [Q, n_slots + 1] boards, the mask and one torch.topk: the
    route's library cost) and the board route's (plan upload, the call,
    the window's copy), beside the bound (the batch's distinct tiles read
    once, the plan read and the window written). On the card the library
    counts the kernels a call launches (it must be 2), and `torch.profiler`
    gives each kernel's device time where its trace shows it (None
    where it shows no device kernel)."""
    from elasticsearch_tpu_torch.ops import bm25, dispatch
    dev = lf.device
    args = _bm25_args(lf, queries, required)
    k = min(BM25_WINDOW, lf.n_slots)
    before = dispatch.launches().get(bm25.KERNEL, 0)
    kernels_before = bm25.kernel_launches() if dev.type == "cuda" else 0
    got = bm25.bm25_board(*args, k, lf.n_slots, range_slots=range_slots)
    if dev.type == "cuda":
        # the kernels the library launched for this one call
        launched = bm25.kernel_launches() - kernels_before
        if dispatch.launches().get(bm25.KERNEL, 0) != before + 1:
            raise AssertionError(f"bm25_board {label}: not one call a batch")
        if launched != 2:
            raise AssertionError(f"bm25_board {label}: {launched} kernel "
                                 f"launches a call, not 2")
    want = bm25.bm25_board_reference(*args, k, lf.n_slots)
    torch.cuda.synchronize()
    _same_board_window(got, want, label)
    if lf.dtype == "f32" and range_slots is None:
        # the host twin over the f32 impacts: the same rows and f32 bits
        host = lf.search_batch(queries, BM25_WINDOW, required=required,
                               route="host")
        board = lf.search_batch(queries, BM25_WINDOW, required=required)
        for (hr, hs), (br, bs) in zip(host, board):
            if not (np.array_equal(hr, br)
                    and np.array_equal(hs.view(np.int32),
                                       bs.view(np.int32))):
                raise AssertionError(f"bm25_board {label}: the board route "
                                     f"differs from the host twin")
    empty = [i for i, (q, _) in enumerate(queries)
             if all(t not in lf.term_tiles for t in q)]
    if any(bool(torch.isfinite(got[0][i]).any()) for i in empty):
        raise AssertionError(f"bm25_board {label}: a query with no tile "
                             f"has a finite score")
    pos_starts, runs = (a.cpu().numpy() for a in args[:2])
    f = {"max_abs_err": 0.0, "queries": len(queries),
         "positions": runs.shape[1]}
    if dev.type == "cuda":
        f["launches_per_batch"] = launched

    def run():
        return bm25.bm25_board(*args, k, lf.n_slots, range_slots=range_slots)

    if dev.type == "cuda":
        plan = bm25.launch_plan(
            len(queries), lf.n_slots, k, range_slots,
            sms=torch.cuda.get_device_properties(dev).multi_processor_count)
        f.update(range_slots=plan.range_slots, n_ranges=plan.n_ranges)
        f["smem_a_bytes"], f["smem_b_bytes"] = bm25.kernel_smem(plan)
    if not timed:
        return f
    if dev.type == "cuda":
        prof = kernel_profile(run, BM25_KERNEL_SYMBOLS, 10)
        f["kernel_a_ms"], f["kernel_b_ms"] = (
            prof[n][1] if prof[n][0] == 1 else None
            for n in BM25_KERNEL_SYMBOLS)
    first, nt = runs[0].astype(np.int64), runs[1].astype(np.int64)
    pair_tiles = np.repeat(first, nt) + (np.arange(int(nt.sum()))
                                         - np.repeat(np.cumsum(nt) - nt, nt))
    distinct = len(np.unique(pair_tiles))
    postings = int((lf.tile_slots[pair_tiles] >= 0).sum())
    lane_bytes = 4 + args[5].element_size()
    tile_bytes = bm25.TILE * lane_bytes + (4 if args[6] is not None else 0)
    io_bytes = 4 * (len(pos_starts) + runs.size + len(queries)) \
        + 8 * len(queries) * k
    # the guide's rule: each distinct tile read once, the plan, the window
    bound_bytes = distinct * tile_bytes + io_bytes
    # for scale: every (query, tile) pair read, no board traffic; and the
    # bytes of a design with its boards in device memory (every pair, 16 B
    # a posting on the boards)
    pair_bytes = len(pair_tiles) * tile_bytes + io_bytes
    boards_bytes = len(pair_tiles) * (bm25.TILE * lane_bytes + 12) \
        + postings * 16

    # the yardstick: every valid lane's (query, slot, value) flattened once
    items = list(bm25._position_items(args[0], args[1]))
    q_all = torch.cat([q for q, _t, _b in items])
    slots, vals = bm25._tile_values(
        torch.cat([t for _q, t, _b in items]),
        torch.cat([b for _q, _t, b in items]), *args[4:])
    valid = slots >= 0
    q_flat = q_all[:, None].expand_as(slots)[valid]
    s_flat, v_flat = slots[valid], vals[valid]
    ones = torch.ones_like(s_flat, dtype=torch.int32)
    need = torch.clamp(args[2], min=1)[:, None]
    nq, n = len(queries), lf.n_slots

    def library():
        s = torch.zeros((nq, n + 1), dtype=torch.float32, device=dev)
        c = torch.zeros((nq, n + 1), dtype=torch.int32, device=dev)
        s.index_put_((q_flat, s_flat), v_flat, accumulate=True)
        c.index_put_((q_flat, s_flat), ones, accumulate=True)
        return torch.topk(torch.where(c[:, :n] >= need, s[:, :n],
                                      torch.full_like(s[:, :n], -math.inf)),
                          k)

    host_plan = np.concatenate([pos_starts, runs.reshape(-1),
                                np.asarray(required, dtype=np.int32)])
    n_runs = runs.shape[1]

    def route():
        p = torch.from_numpy(host_plan).to(dev)
        v, s = bm25.bm25_board(
            p[:nq + 1], p[nq + 1:nq + 1 + 3 * n_runs].view(3, n_runs),
            p[nq + 1 + 3 * n_runs:], *args[3:], k, n)
        return torch.stack([v.view(torch.int32), s]).cpu()

    f.update(ms=time_ms(run), burst_ms=burst_ms(run),
             plain_ms=time_ms(lambda: bm25.bm25_board_reference(
                 *args, k, n), iters=5, warmup=1),
             library_ms=time_ms(library, iters=5, warmup=1),
             route_ms=time_ms(route), pairs=len(pair_tiles),
             distinct_tiles=distinct, postings=postings)
    f["bound_ms"], f["bound_by"] = bound_ms(bound_bytes, 0, 1.0)
    f["pairs_bound_ms"] = bound_ms(pair_bytes, 0, 1.0)[0]
    f["boards_bound_ms"] = bound_ms(boards_bytes, 0, 1.0)[0]
    return f


def phase_bm25_kernel(seed: int, dev, n_slots: int, n_sparse: int) -> dict:
    """bm25_board against its plain version on the card, windows bit for
    bit, on a synthetic Zipf layout over `n_slots` docs (serve_hybrid's
    width): f32, bf16 and int8 impacts, each at Q = 32 (a repeated word,
    an out-of-vocabulary word, a query with no tile, required 2 and 3)
    and Q = 1, timed beside the bound (the distinct tiles read once, the
    plan and the window), the plain version and the yardstick (an
    index_put_ pair, the mask, torch.topk); then forced ranges of 64 and
    2,048 slots on a field of 16,384 docs (k = 100 past the first); then
    the learned-sparse cases over `n_sparse` docs."""
    from elasticsearch_tpu_torch.ops import bm25
    rng = np.random.default_rng(seed + 7)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    queries, required, ranks = _bm25_queries(rng, 32)
    base = _bm25_field(g, dev, "f32", n_slots, ranks.reshape(-1), rng)
    cases = {}
    for dtype in ("f32", "bf16", "int8"):
        lf = bm25.LexicalField("body", dtype, device=dev)
        for key in ("n_slots", "row_map", "term_tiles", "tile_slots",
                    "tile_impacts", "tile_first", "nnz"):
            setattr(lf, key, getattr(base, key))
        lf.version = ("synthetic", dtype)
        for label, qs, req in ((f"{dtype}_q32", queries, required),
                               (f"{dtype}_q1", queries[5:6], required[5:6])):
            cases[label] = _bm25_case(lf, qs, req, label, timed=True)
            log("kernels", kernel=bm25.KERNEL, case=label, n_slots=n_slots,
                tiles=len(base.tile_slots),
                **{k: (f"{v:.6g}" if isinstance(v, float) else v)
                   for k, v in cases[label].items()},
                library="zeroed boards + torch index_put_(accumulate=True) "
                        "of the flattened valid lanes, scores and counts + "
                        "mask + torch.topk",
                route="plan upload + bm25_board + window copy")
        del lf
    del base
    small = _bm25_field(g, dev, "f32", 1 << 14, ranks.reshape(-1), rng)
    for r in (64, 2048):     # k = 100 past a range of 64 slots
        f = _bm25_case(small, queries, required, f"small_r{r}", timed=False,
                       range_slots=r)
        log("kernels", kernel=bm25.KERNEL, case=f"small_r{r}", n_slots=1 << 14,
            window=min(BM25_WINDOW, 1 << 14), **f)
    sparse_cases = sparse_board_cases(seed, dev, n_sparse)
    c, sc = cases["f32_q32"], sparse_cases["sparse_f32_q32"]
    return {bm25.KERNEL: {
        "name": bm25.KERNEL, "route": "cuda",
        "source": "elasticsearch_tpu_torch/csrc/bm25.cu",
        "replaces": "elasticsearch_tpu/ops/bm25.py:493",
        "max_abs_err": max(x["max_abs_err"] for x in
                           (*cases.values(), *sparse_cases.values())),
        "ms": c["ms"], "burst_ms": c["burst_ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": c["library_ms"], "route_ms": c["route_ms"],
        "launches_per_batch": c["launches_per_batch"],
        # the learned-sparse shape (ops/sparse.py; replaces sparse.topk,
        # elasticsearch_tpu/ops/sparse.py:187), Q = 32, f32 weights
        "sparse_positions": sc["positions"],
        "sparse_launches_per_batch": sc["launches_per_batch"],
        "sparse_ms": sc["ms"],
        "sparse_burst_ms": sc["burst_ms"], "sparse_plain_ms": sc["plain_ms"],
        "sparse_bound_ms": sc["bound_ms"],
        "sparse_library_ms": sc["library_ms"],
        "sparse_route_ms": sc["route_ms"]}}


# ------------------------------------------------------- learned sparse

# The reference's learned-sparse deployment: MS MARCO passage (8,841,823
# passages) expanded by a BERT-wordpiece learned-sparse model (SPLADE,
# Elastic's ELSER): 30,522 token ids, 64-256 nonzero tokens a passage
# (mean ~120), positive f32 weights in (0, 3], token popularity Zipf over
# the ids; queries of 20-120 tokens (a source passage's tokens and
# expansion tokens). Cut to 262,144 passages as serve_hybrid is (PERF.md
# section 4).
SPARSE_VOCAB = 30_522
SPARSE_DOC_TOKENS = (64, 256)
SPARSE_MEAN_TOKENS = 120
SPARSE_QUERY_TOKENS = (20, 121)
SPARSE_WIDE_TOKENS = (257, 301)     # the reference's walker takes these
SPARSE_SOURCE_SHARE = 0.7           # a query's tokens from its passage
N_SPARSE = 1 << 18
N_SPARSE_WALKER = 50_000
SPARSE_CHUNK = 1 << 12
SPARSE_TOKENS = np.array([f"t{i}" for i in range(SPARSE_VOCAB)],
                         dtype=object)


def sparse_popularity() -> tuple:
    """(p, inclusion): Zipf (s = 1.0) token probabilities over the ids, and
    the share of passages holding each token when a passage draws
    SPARSE_MEAN_TOKENS distinct tokens by p (1 - exp(-lam p), lam set so
    the shares sum to the mean)."""
    p = np.diff(np.concatenate([[0.0], zipf_cdf(SPARSE_VOCAB)]))
    lo, hi = float(SPARSE_MEAN_TOKENS), 1e9
    for _ in range(100):
        lam = (lo + hi) / 2
        if (-np.expm1(-lam * p)).sum() < SPARSE_MEAN_TOKENS:
            lo = lam
        else:
            hi = lam
    return p, -np.expm1(-lo * p)


def sparse_weights(g, n: int, dev) -> torch.Tensor:
    """n positive f32 weights in (0, 3]."""
    return 3.0 * (1.0 - torch.rand(n, generator=g, device=dev))


def sparse_query(rng, source: np.ndarray, n_tok: int, p) -> dict:
    """A query of n_tok tokens: SPARSE_SOURCE_SHARE of them (at most the
    passage's) from its source passage's tokens, the rest expansion
    tokens drawn by popularity from outside the passage; f32 weights in
    (0, 3], in that order."""
    n_src = min(int(round(SPARSE_SOURCE_SHARE * n_tok)), len(source))
    src = rng.choice(source, n_src, replace=False)
    q = np.zeros(SPARSE_VOCAB)
    q[source] = 1.0
    pe = np.where(q > 0, 0.0, p)
    extra = rng.choice(SPARSE_VOCAB, n_tok - n_src, replace=False,
                       p=pe / pe.sum())
    toks = np.concatenate([src, extra])
    w = (3.0 * (1.0 - rng.random(len(toks)))).astype(np.float32)
    return dict(zip(SPARSE_TOKENS[toks].tolist(), w.tolist()))


def _sparse_field(g, dev, n_slots: int, tokens, rng):
    """A SparseField over a synthetic learned-sparse layout: token t in
    about n_slots * inclusion[t] random docs, weights in (0, 3]; the tiles
    of every token in `tokens` (each run padded to whole 128-lane tiles,
    as `LexicalField._install_tiles` lays them out)."""
    from elasticsearch_tpu_torch.ops import bm25, sparse
    _p, incl = sparse_popularity()
    spans, slot_parts, tile = {}, [], 0
    for t in sorted(set(int(x) for x in tokens)):
        df = max(int(round(n_slots * incl[t])), 1)
        slots = torch.randperm(n_slots, generator=g, device=dev)[:df]
        nt = -(-df // bm25.TILE)
        pad = torch.full((nt * bm25.TILE,), -1, dtype=torch.int32, device=dev)
        pad[:df] = torch.sort(slots).values.to(torch.int32)
        slot_parts.append(pad)
        spans[f"t{t}"] = (tile, nt)
        tile += nt
    sf = sparse.SparseField("tokens", "f32", device=dev)
    sf.n_slots, sf.row_map = n_slots, np.arange(n_slots, dtype=np.int64)
    sf.term_tiles, sf.version = spans, ("synthetic", "f32")
    sf.tile_slots = torch.cat(slot_parts).reshape(-1, bm25.TILE).cpu().numpy()
    sf.tile_first = np.ascontiguousarray(sf.tile_slots[:, 0])
    sf.tile_impacts = np.where(
        sf.tile_slots >= 0,
        (3.0 * (1.0 - rng.random(sf.tile_slots.shape))), 0.0
    ).astype(np.float32)
    sf.nnz = int((sf.tile_slots >= 0).sum())
    return sf


def sparse_board_inputs(seed: int, dev, n_slots: int):
    """The learned-sparse kernel cases' f32 field and 33 queries: 32 of
    20-120 tokens, then one of 300."""
    rng = np.random.default_rng(seed + 10)
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    p, incl = sparse_popularity()
    queries = []
    for i in range(33):
        n_tok = (300 if i == 32 else int(rng.integers(*SPARSE_QUERY_TOKENS)))
        source = rng.choice(SPARSE_VOCAB, int(rng.integers(
            *SPARSE_DOC_TOKENS)), replace=False, p=incl / incl.sum())
        queries.append((sparse_query(rng, source, n_tok, p),
                        1.0 + 0.5 * (i % 3)))
    tokens = [int(t[1:]) for q, _b in queries for t in q]
    return _sparse_field(g, dev, n_slots, tokens, rng), queries


def sparse_board_cases(seed: int, dev, n_slots: int = N_SPARSE) -> dict:
    """bm25_board on the learned-sparse layout over `n_slots` docs (the
    board width of serve_sparse): 32 queries of 20-120 tokens, each
    token's entry with its own boost, Q = 1, and Q = 1 of 300 tokens (as
    wide as the reference sends to its walker); f32, bf16 and int8
    weights; the windows bit for bit against the plain version and, at
    f32, the board route against the host twin; timed as the BM25 cases,
    one call (two launches) a batch whatever the token count."""
    from elasticsearch_tpu_torch.ops import bm25, sparse
    base, queries = sparse_board_inputs(seed, dev, n_slots)
    required = np.ones(len(queries), dtype=np.int32)
    cases = {}
    for dtype in ("f32", "bf16", "int8"):
        sf = sparse.SparseField("tokens", dtype, device=dev)
        for key in ("n_slots", "row_map", "term_tiles", "tile_slots",
                    "tile_impacts", "tile_first", "nnz"):
            setattr(sf, key, getattr(base, key))
        sf.version = ("synthetic", dtype)
        for label, qs in ((f"sparse_{dtype}_q32", queries[:32]),
                          (f"sparse_{dtype}_q1", queries[5:6]),
                          (f"sparse_{dtype}_wide_q1", queries[32:])):
            f = _bm25_case(sf, qs, required[:len(qs)], label, timed=True)
            f["tokens_per_query"] = float(np.mean([len(q) for q, _ in qs]))
            f["postings_per_query"] = f["postings"] / len(qs)
            cases[label] = f
            log("kernels", kernel=bm25.KERNEL, variant=sparse.VARIANT,
                case=label, n_slots=n_slots, tiles=len(base.tile_slots),
                **{k: (f"{v:.6g}" if isinstance(v, float) else v)
                   for k, v in f.items()},
                library="zeroed boards + torch index_put_(accumulate=True) "
                        "of the flattened valid lanes, scores and counts + "
                        "mask + torch.topk",
                route="plan upload + bm25_board + window copy")
        del sf
    return cases


# ------------------------------------------------------------ serve_hybrid

def msmarco_chunks(seed: int, n: int, dev):
    """MS MARCO-shaped passages from `seed`: yields (first doc, token ids
    [T] int32 on `dev`, per-doc word counts) chunks of MSMARCO_CHUNK docs,
    the words Zipf-drawn (s = 1.0) over MSMARCO_VOCAB, as `w<rank>`."""
    rng = np.random.default_rng(seed + 8)
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    cdf = torch.from_numpy(zipf_cdf()).to(dev)
    for lo in range(0, n, MSMARCO_CHUNK):
        m = min(MSMARCO_CHUNK, n - lo)
        lengths = rng.integers(*MSMARCO_WORDS, size=m)
        u = torch.rand(int(lengths.sum()), generator=g, device=dev,
                       dtype=torch.float64)
        toks = torch.searchsorted(cdf, u).clamp_max(MSMARCO_VOCAB - 1)
        yield lo, toks.to(torch.int32), lengths


WORDS = np.array([f"w{r}" for r in range(MSMARCO_VOCAB)], dtype=object)


def passage_texts(toks: np.ndarray, lengths: np.ndarray) -> list:
    ends = np.cumsum(lengths)
    return [" ".join(WORDS[toks[e - n:e]]) for e, n in zip(ends, lengths)]


def hybrid_body(text, qv: np.ndarray, form: str = "query",
                operator: Optional[str] = None, generic=None) -> dict:
    """BASELINE config 3's body: `match` on `body` + `knn` on `emb`,
    fused by RRF; as `query` + `knn` or as `sub_searches` (with an
    optional third, generic, sub-search)."""
    match = {"match": {"body": text if operator is None
                       else {"query": text, "operator": operator}}}
    knn = {"field": "emb", "query_vector": qv.tolist(), "k": 10,
           "num_candidates": 100}
    if form == "query":
        return {"query": match, "knn": knn, "rank": {"rrf": {}},
                "size": 10, "_source": False}
    subs = [{"query": match}, {"query": {"knn": knn}}]
    if generic is not None:
        subs.append({"query": generic})
    return {"sub_searches": subs, "rank": {"rrf": {}}, "size": 10,
            "_source": False}


def bm25_f64_top(tokens, doc_of, lengths_d, terms, k: int):
    """The independent oracle: float64 BM25 (k1 1.2, b 0.75) of one
    query's terms (each occurrence a clause) over the generated token ids
    on the card; returns (top-k docs by (score desc, doc asc), the scores
    of every doc)."""
    n = len(lengths_d)
    avg = float(lengths_d.sum()) / n
    score = torch.zeros(n, dtype=torch.float64, device=lengths_d.device)
    norm = 1.2 * (0.25 + 0.75 * lengths_d / avg)
    for t in terms:
        if not t.startswith("w") or not t[1:].isdigit():
            continue
        f = torch.bincount(doc_of[tokens == int(t[1:])],
                           minlength=n).to(torch.float64)
        df = int((f > 0).sum())
        if not df:
            continue
        idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
        score += idf * 2.2 * f / (f + norm)
    order = torch.argsort(-score, stable=True)[:k]
    keep = score[order] > 0
    return order[keep].cpu().numpy(), score


def phase_serve_hybrid(seed: int, n: int, device: str = "cuda") -> dict:
    """serve_hybrid: BASELINE config 3 (MS MARCO passage, hybrid BM25 +
    kNN by RRF, 768-d), cut from 8,841,823 to `n` passages. One shard:
    `body` text (standard analyzer), `emb` 768-d cosine `flat` (the bf16
    binned kernel), `len` integer; 1,000 passages over `_bulk`, the rest
    through `IndexService.index_many`, one refresh, the lexical layout
    built (`LexicalField.sync`). 64 queries of 6 words of a source passage
    and its embedding plus noise. Gates: each lexical leg's ranked window
    (100) byte-identical in rows and f32 scores to the same `match` sent
    alone as `query` through `_search` (the host path; `operator: and`
    too); its top 10 against an independent float64 BM25 over the same
    tokens (a difference only among tied or 1-ulp scores at the cut); the
    kNN leg's recall@10 >= 0.95 against exact f32 numpy; every hybrid
    response (query + knn and sub_searches forms, `operator: and`, a
    generic `range` leg, text that analyzes to nothing) equal to host RRF
    of its legs; one bm25_board call a request, and at C = 1 and 8
    one a batch. Returns the launches."""
    from elasticsearch_tpu_torch.ops import bm25, dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    from elasticsearch_tpu_torch.search.hybrid_plan import compile_plan
    from elasticsearch_tpu_torch.server import build_server
    dev = torch.device(device)
    name = "msmarco"
    rng = np.random.default_rng(seed + 9)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    node, server = build_server(device=device, port=0,
                                settings=SERVE_SETTINGS)
    server.start()
    total = {bm25.KERNEL: 0, kb.KERNEL_BF16: 0}
    try:
        client = Client(server.port)
        index_body = {
            "settings": {"number_of_shards": 1},
            "mappings": {"properties": {
                "body": {"type": "text", "analyzer": "standard"},
                "emb": {"type": "dense_vector", "dims": 768,
                        "similarity": "cosine",
                        "index_options": {"type": "flat"}},
                "len": {"type": "integer"}}}}
        client.ok("PUT", f"/{name}", index_body)
        svc = node.index(name)
        emb = clustered(rng, n, 768)
        tok_parts, len_parts, clock = [], [], {"data": 0.0, "ingest": 0.0}
        src_texts = {}
        first = min(1000, n)
        for lo, toks, lengths in msmarco_chunks(seed, n, dev):
            t = time.perf_counter()
            host_toks = toks.cpu().numpy()
            texts = passage_texts(host_toks, lengths)
            tok_parts.append(toks)
            len_parts.append(lengths)
            for i in range(lo, lo + len(texts)):
                if i % (n // 64 + 1) == 7 or i == 7:
                    src_texts[i] = texts[i - lo]
            clock["data"] += time.perf_counter() - t
            t = time.perf_counter()
            sources = [{"body": txt, "len": int(ln)}
                       for txt, ln in zip(texts, lengths)]
            cut = max(first - lo, 0)
            if cut:
                ops = []
                for i in range(lo, lo + cut):
                    ops += [{"index": {"_id": str(i)}},
                            dict(sources[i - lo], emb=emb[i].tolist())]

                def small_match(path):
                    probe = src_texts[7].split()
                    hits = client.ok("POST", path, {
                        "query": {"match": {"body": {
                            "query": " ".join(probe[:8]),
                            "operator": "and"}}},
                        "size": first, "_source": False})["hits"]["hits"]
                    if not hits or "7" not in {h["_id"] for h in hits}:
                        raise AssertionError(f"small-index match: {hits}")

                small_index_check(client, name, index_body, ops, small_match)
                if client.ok("POST", f"/{name}/_bulk", ops,
                             ndjson=True)["errors"]:
                    raise AssertionError("serve_hybrid: bulk errors")
            if len(texts) > cut:
                svc.index_many([str(i) for i in range(lo + cut,
                                                      lo + len(texts))],
                               sources[cut:],
                               vectors={"emb": emb[lo + cut:lo + len(texts)]})
            clock["ingest"] += time.perf_counter() - t
        t = time.perf_counter()
        client.ok("POST", f"/{name}/_refresh")
        clock["ingest"] += time.perf_counter() - t
        tokens = torch.cat(tok_parts)
        del tok_parts
        lengths = np.concatenate(len_parts)
        doc_of = torch.repeat_interleave(
            torch.arange(n, device=dev, dtype=torch.int32),
            torch.from_numpy(lengths).to(dev))
        lengths_d = torch.from_numpy(lengths).to(dev).to(torch.float64)

        ex = node._hybrid_executor(svc)
        reader = svc.combined_reader()
        t = time.perf_counter()
        lf = ex.lexical.field(reader, "body")
        build_s = time.perf_counter() - t

        # queries: 6 words of a source passage, its embedding + noise
        srcs = sorted(src_texts)[:64]
        q_text = [" ".join(rng.choice(src_texts[i].split(),
                                      MSMARCO_QUERY_WORDS, replace=False))
                  for i in srcs]
        q_emb = emb[srcs] + 0.3 * rng.standard_normal(
            (len(srcs), 768)).astype(np.float32)
        truth = exact_top(emb, q_emb, 10, "cosine")
        mapper = svc.mapper_service.get("body")

        # the host path: `match` alone through `_search`
        dispatch.reset_launches()
        match_lat, host_hits = [], []
        for text in q_text:
            t = time.perf_counter()
            resp = client.ok("POST", f"/{name}/_search", {
                "query": {"match": {"body": text}}, "size": BM25_WINDOW,
                "_source": False})
            match_lat.append((time.perf_counter() - t) * 1e3)
            host_hits.append(resp["hits"]["hits"])
        if any(dispatch.launches().values()):
            raise AssertionError(f"serve_hybrid: the host match launched "
                                 f"{dispatch.launches()}")

        # the lexical leg: byte-identical to the host path; the f64 oracle
        leg_lat, ties, ulp_cuts = [], 0, 0
        for qi, text in enumerate(q_text):
            terms = mapper.search_analyzer.terms(text)
            t = time.perf_counter()
            (rows, scores), = ex.lexical.search_batch(
                reader, "body", [(terms, 1.0)], BM25_WINDOW)
            leg_lat.append((time.perf_counter() - t) * 1e3)
            want = host_hits[qi]
            if [reader.get_id(int(r)) for r in rows] \
                    != [h["_id"] for h in want] or not np.array_equal(
                        scores.view(np.int32),
                        np.asarray([h["_score"] for h in want],
                                   dtype=np.float32).view(np.int32)):
                raise AssertionError(f"serve_hybrid query {qi}: the "
                                     f"lexical leg differs from `_search`")
            ties += int((np.diff(scores) == 0).sum())
            top64, s64 = bm25_f64_top(tokens, doc_of, lengths_d, terms, 10)
            mine = rows[:10]
            tenth = float(s64[int(top64[-1])])
            for doc in set(mine.tolist()) ^ set(top64.tolist()):
                if abs(float(s64[doc]) - tenth) > 2e-6 * tenth:
                    raise AssertionError(
                        f"serve_hybrid query {qi}: doc {doc} "
                        f"(f64 {float(s64[doc])}) against the f64 top 10's "
                        f"cut {tenth}")
                ulp_cuts += 1
            err = np.abs(scores[:10].astype(np.float64)
                         - s64[torch.from_numpy(mine).to(dev)].cpu().numpy())
            if (err > 1e-5 * np.abs(scores[:10])).any():
                raise AssertionError(f"serve_hybrid query {qi}: f32 scores "
                                     f"{scores[:10]} off the f64 oracle")

        # `operator: and`: the leg against `_search` likewise
        for qi, text in enumerate(q_text[:16]):
            terms = mapper.search_analyzer.terms(text)
            (rows, scores), = ex.lexical.search_batch(
                reader, "body", [(terms, 1.0)], BM25_WINDOW,
                required=[len(terms)])
            want = client.ok("POST", f"/{name}/_search", {
                "query": {"match": {"body": {"query": text,
                                             "operator": "and"}}},
                "size": BM25_WINDOW, "_source": False})["hits"]["hits"]
            if [reader.get_id(int(r)) for r in rows] \
                    != [h["_id"] for h in want] or not np.array_equal(
                        scores.view(np.int32),
                        np.asarray([h["_score"] for h in want],
                                   dtype=np.float32).view(np.int32)):
                raise AssertionError(f"serve_hybrid and-query {qi}: the "
                                     f"lexical leg differs from `_search`")

        # hybrid requests over HTTP, each against host RRF of its legs
        bodies = [hybrid_body(t, qv) for t, qv in zip(q_text, q_emb)]
        client.ok("POST", f"/{name}/_search", bodies[0])    # warm-up
        ex0 = dict(ex.stats)
        dispatch.reset_launches()
        kernels0 = bm25.kernel_launches() if device == "cuda" else 0
        lat, responses = [], []
        for body in bodies:
            t = time.perf_counter()
            responses.append(client.ok("POST", f"/{name}/_search",
                                       body)["hits"])
            lat.append((time.perf_counter() - t) * 1e3)
        launches = {k: c for k, c in dispatch.launches().items() if c}
        want = {bm25.KERNEL: len(bodies), kb.KERNEL_BF16: len(bodies)}
        if launches != want:
            raise AssertionError(f"serve_hybrid: launches {launches} for "
                                 f"{len(bodies)} requests; expected {want}")
        if device == "cuda":
            # the board kernels the library launched: two a call
            board_kernels = bm25.kernel_launches() - kernels0
            if board_kernels != 2 * launches[bm25.KERNEL]:
                raise AssertionError(f"serve_hybrid: {board_kernels} board "
                                     f"kernel launches for "
                                     f"{launches[bm25.KERNEL]} calls")
            log("serve_hybrid", board_kernel_launches=board_kernels,
                board_calls=launches[bm25.KERNEL])
        for key, c in launches.items():
            total[key] += c
        stages = {k: (ex.stats[k] - ex0[k]) / len(bodies) / 1e6
                  for k in ("plan_nanos", "score_nanos", "fuse_nanos",
                            "hydrate_nanos")}
        extra = [hybrid_body(q_text[i], q_emb[i], form="sub_searches")
                 for i in range(8)]
        extra += [hybrid_body(q_text[8], q_emb[8], operator="and"),
                  hybrid_body(q_text[9], q_emb[9], form="sub_searches",
                              generic={"range": {"len": {"gte": 56}}}),
                  hybrid_body("!!! ?? ...", q_emb[10])]
        host, knn_rows = [], []
        for bi, body in enumerate(bodies + extra):
            got = responses[bi] if bi < len(bodies) else \
                client.ok("POST", f"/{name}/_search", body)["hits"]
            plan = compile_plan(body, svc.mapper_service)
            legs = ex.score_legs(reader, [plan], [plan.bind(body)])[0]
            rows, scores = _host_rrf(legs)
            want_ids = [reader.get_id(r) for r in rows[:10]]
            if [h["_id"] for h in got["hits"]] != want_ids \
                    or [h["_score"] for h in got["hits"]] != scores[:10] \
                    or got["total"]["value"] != len(rows):
                raise AssertionError(f"serve_hybrid body {bi}: differs from "
                                     f"host RRF of its legs")
            if bi < len(bodies):
                host.append((want_ids, scores[:10], len(rows)))
                knn_rows.append(legs[1][:10])
        if len(legs[0]):
            raise AssertionError("serve_hybrid: text that analyzes to "
                                 "nothing gave lexical hits")
        recall = float(np.mean([
            len({int(reader.get_id(int(r))) for r in rows}
                & set(t.tolist())) / 10
            for rows, t in zip(knn_rows, truth)]))
        if recall < 0.95:
            raise AssertionError(f"serve_hybrid kNN leg recall@10 {recall} "
                                 f"< 0.95")

        # every body's legs as one batch: one board for the batch
        dispatch.reset_launches()
        plans = [compile_plan(b, svc.mapper_service) for b in bodies]
        ex.score_legs(reader, plans, [p.bind(b)
                                      for p, b in zip(plans, bodies)])
        batched = dispatch.launches().get(bm25.KERNEL, 0)
        if batched != 1:
            raise AssertionError(f"serve_hybrid: {batched} bm25_board launch "
                                 f"sets for one batch of {len(bodies)}")
        fields = dict(
            docs=n, vocab=MSMARCO_VOCAB, tokens=int(lengths.sum()),
            data_s=f"{clock['data']:.2f}", ingest_s=f"{clock['ingest']:.2f}",
            lexical_build_s=f"{build_s:.2f}", tiles=len(lf.tile_slots),
            postings=lf.nnz, tile_gb=f"{lf.nbytes() / 1e9:.3f}",
            requests=len(bodies),
            match_p50_ms=f"{statistics.median(match_lat):.3f}",
            hybrid_p50_ms=f"{statistics.median(lat):.3f}",
            lexical_leg_p50_ms=f"{statistics.median(leg_lat):.3f}",
            recall_at_10=recall, window_ties=ties, f64_cut_ulps=ulp_cuts,
            launches_per_request=json.dumps(
                {k: c / len(bodies) for k, c in launches.items()}))
        for stage, ms in stages.items():
            fields[f"{stage.split('_')[0]}_stage_ms"] = f"{ms:.4f}"
        if dev.type == "cuda":
            fields["device_peak_gb"] = \
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f}"
        fields["host_peak_rss_gb"] = (f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9:.2f}")
        log("serve_hybrid", **fields)
        t = time.perf_counter()
        dsl_msmarco(client, name, tokens, doc_of, n)
        log("timing", step="dsl_msmarco",
            seconds=f"{time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        search_api_msmarco(client, name, tokens, doc_of, n)
        log("timing", step="search_api_msmarco",
            seconds=f"{time.perf_counter() - t:.1f}")
        del tokens, doc_of

        # concurrent clients: batch-1 answers exactly, one board a batch
        def check(qi, payload):
            hits = payload["hits"]
            if hits["total"]["value"] != host[qi][2]:
                raise AssertionError(f"{name} query {qi}: total "
                                     f"{hits['total']} against {host[qi][2]}")
            return against_batch1(f"{name} query {qi}",
                                  [h["_id"] for h in hits["hits"]],
                                  [h["_score"] for h in hits["hits"]],
                                  host[qi][0], host[qi][1], 0.0)

        batches0 = ex.batcher.sched["batches"]
        conc = serve_concurrent(
            name, server.port, f"/{name}/_search", bodies, (1, 8),
            2 * len(bodies), check, lambda: dict(ex.batcher.sched),
            (ex.batcher, "_dispatch_fn", 0),
            {f"{kb.KERNEL_BF16}/{kb.VARIANT_TMA}"})
        batches = ex.batcher.sched["batches"] - batches0
        if conc.get(bm25.KERNEL, 0) != batches:
            raise AssertionError(f"serve_hybrid concurrent: "
                                 f"{conc.get(bm25.KERNEL, 0)} bm25_board "
                                 f"calls for {batches} batches")
        for key, c in conc.items():
            total[key] = total.get(key, 0) + c
        log("serve_hybrid", concurrent_batches=batches,
            bm25_calls=conc.get(bm25.KERNEL, 0))
        for key, c in hybrid_repeat_pass(client, node, name, bodies,
                                         responses, device).items():
            total[key] += c
        total[kb.KERNEL_BF16] += serve_body_msmarco(client, node, svc,
                                                    q_text, q_emb, emb)
        for key, c in telemetry_hybrid(client, node, name,
                                       bodies[0]).items():
            total[key] = total.get(key, 0) + c
        drop_index(client, name)
    finally:
        server.stop()
    return total


DSL_REQUESTS = 16       # HTTP requests a [dsl] body, for its p50


def edits1(term: str, alphabet: str) -> set:
    """The strings within one edit (insertion, deletion, substitution or
    adjacent transposition) of `term` over `alphabet`: the oracle of the
    fuzzy bodies (AUTO: one edit at 3 to 5 characters), independent of the
    port's enumeration of the terms."""
    splits = [(term[:i], term[i:]) for i in range(len(term) + 1)]
    out = {term}
    out |= {a + b[1:] for a, b in splits if b}
    out |= {a + b[1] + b[0] + b[2:] for a, b in splits if len(b) > 1}
    out |= {a + c + b[1:] for a, b in splits if b for c in alphabet}
    out |= {a + c + b for a, b in splits for c in alphabet}
    return out


def _page_in_order(label: str, hits) -> None:
    """The reference's order of a page: score descending, ties by row
    (here the `_id`'s number)."""
    keys = [(-h["_score"], int(h["_id"])) for h in hits]
    if keys != sorted(keys):
        raise AssertionError(f"[dsl] {label}: page out of order {keys}")


def dsl_timed(client, path: str, label: str, body, fields: dict,
              query: str = "") -> dict:
    """DSL_REQUESTS requests of one body: its HTTP p50 into `fields`; every
    answer equal to the first. Returns the first."""
    lat, first = [], None
    for _ in range(DSL_REQUESTS):
        t = time.perf_counter()
        if body is None:
            status, resp = client.req("GET", path + query)
            if status != 200:
                raise AssertionError(f"[dsl] {label}: {status} {resp}")
        else:
            resp = client.ok("POST", path, body)
        lat.append((time.perf_counter() - t) * 1e3)
        resp.pop("took", None)
        if first is None:
            first = resp
        elif resp != first:
            raise AssertionError(f"[dsl] {label}: answers differ")
    fields[f"{label}_p50_ms"] = f"{statistics.median(lat):.3f}"
    return first


def dsl_msmarco(client, name: str, tokens, doc_of, n: int) -> None:
    """The query DSL on msmarco (serve_hybrid's index, `body` text of
    Zipf words `w<rank>`): `prefix`, `wildcard`, `regexp`, `fuzzy` (AUTO),
    `match` with `fuzziness`, `match_phrase_prefix`, `query_string` (AND,
    a phrase, a field wildcard), the URL `q` with `df`, `dis_max`,
    `boosting` and `function_score`: each body's total (tracked) equal to
    numpy's count over the generated token arrays of the docs holding a
    term the pattern or edit distance admits (a phrase: the term pair
    adjacent in one doc; the phrase prefix's first 50 sorted expansions),
    its first page in the reference's order; then a term `suggest` of a
    misspelt frequent word, whose first option is the word. Logs one
    `[dsl] part=msmarco` line of HTTP p50s (DSL_REQUESTS each)."""
    tok = tokens.cpu().numpy().astype(np.int64)
    doc = doc_of.cpu().numpy().astype(np.int64)
    present = np.unique(tok)
    vocab = [f"w{r}" for r in present.tolist()]
    fields: dict = {"part": "msmarco", "docs": n, "terms": len(vocab),
                    "requests_a_body": DSL_REQUESTS}

    def ranks(pred) -> np.ndarray:
        return np.asarray([int(w[1:]) for w in vocab if pred(w)],
                          dtype=np.int64)

    def docs_with(*rank_sets) -> np.ndarray:
        sel = np.zeros(MSMARCO_VOCAB, dtype=bool)
        for rs in rank_sets:
            sel[rs] = True
        return np.unique(doc[sel[tok]])

    def adjacent(first_rank: int, second: np.ndarray) -> np.ndarray:
        sel = np.zeros(MSMARCO_VOCAB, dtype=bool)
        sel[second] = True
        hit = (tok[:-1] == first_rank) & sel[tok[1:]] & (doc[:-1] == doc[1:])
        return np.unique(doc[:-1][hit])

    known = set(vocab)

    def fuzzy(term: str) -> np.ndarray:
        # the words are `w` and digits; AUTO allows these terms one edit
        assert 3 <= len(term) <= 5
        return np.asarray(sorted(int(w[1:]) for w in
                                 edits1(term, "w0123456789") & known),
                          dtype=np.int64)

    def expect(label: str, resp: dict, want_docs: np.ndarray) -> None:
        hits = resp["hits"]
        if hits["total"] != {"value": len(want_docs), "relation": "eq"}:
            raise AssertionError(f"[dsl] {label}: total {hits['total']}, "
                                 f"numpy {len(want_docs)}")
        got = [int(h["_id"]) for h in hits["hits"]]
        if len(got) != min(10, len(want_docs)) \
                or not np.isin(got, want_docs).all():
            raise AssertionError(f"[dsl] {label}: hits {got} outside "
                                 f"numpy's docs")
        _page_in_order(label, hits["hits"])
        fields[f"{label}_total"] = len(want_docs)

    a, b, c = "w150", "w77", "w7"
    ra, rb = np.asarray([150]), np.asarray([77])
    phrase_exp = sorted(w for w in vocab if w.startswith(c))[:50]
    fz1, fz2, fz3 = "w1x34", "w2x7", "w5y5"
    bodies = [
        ("prefix", {"prefix": {"body": "w123"}},
         docs_with(ranks(lambda w: w.startswith("w123")))),
        ("wildcard", {"wildcard": {"body": "w4?7*"}},
         docs_with(ranks(lambda w: re.fullmatch(r"w4.7.*", w)))),
        ("regexp", {"regexp": {"body": "w9[0-9]{2}"}},
         docs_with(ranks(lambda w: re.fullmatch(r"w9[0-9]{2}", w)))),
        ("fuzzy", {"fuzzy": {"body": fz1}}, docs_with(fuzzy(fz1))),
        ("match_fuzziness", {"match": {"body": {
            "query": f"{fz2} {fz3}", "fuzziness": "AUTO"}}},
         docs_with(fuzzy(fz2), fuzzy(fz3))),
        ("phrase_prefix", {"match_phrase_prefix": {"body": f"{a} {c}"}},
         adjacent(150, np.asarray([int(w[1:]) for w in phrase_exp]))),
        ("qs_and", {"query_string": {"query": f"{a} AND {b}"}},
         np.intersect1d(docs_with(ra), docs_with(rb))),
        ("qs_phrase", {"query_string": {"query": f'"{a} {c}"'}},
         adjacent(150, np.asarray([7]))),
        ("qs_wildcard", {"query_string": {"query": "body:w456*"}},
         docs_with(ranks(lambda w: w.startswith("w456")))),
        ("dis_max", {"dis_max": {"queries": [
            {"match": {"body": a}}, {"match": {"body": b}}],
            "tie_breaker": 0.3}}, docs_with(ra, rb)),
        ("boosting", {"boosting": {"positive": {"match": {"body": a}},
                                   "negative": {"match": {"body": c}},
                                   "negative_boost": 0.5}},
         docs_with(ra)),
        ("function_score", {"function_score": {
            "query": {"match": {"body": b}},
            "field_value_factor": {"field": "len", "modifier": "log1p"},
            "boost_mode": "multiply"}}, docs_with(rb)),
    ]
    for label, query, want_docs in bodies:
        resp = dsl_timed(client, f"/{name}/_search", label, {
            "query": query, "size": 10, "track_total_hits": True,
            "_source": False}, fields)
        expect(label, resp, want_docs)
    resp = dsl_timed(client, f"/{name}/_search", "uri_q", None, fields,
                     query=f"?q={a}%20{b}&df=body&track_total_hits=true"
                           f"&_source=false")
    expect("uri_q", resp, docs_with(ra, rb))
    resp = dsl_timed(client, f"/{name}/_search", "suggest", {
        "size": 0, "request_cache": False,
        "suggest": {"s": {"text": "w0x", "term": {
            "field": "body"}}}}, fields)
    options = resp["suggest"]["s"][0]["options"]
    if not options or options[0]["text"] != "w0":
        raise AssertionError(f"[dsl] suggest of w0x: {options[:3]}")
    fields["suggest_first"] = options[0]["text"]
    log("dsl", **fields)


# ----------------------------------------------------------------- search_api

SEARCH_API_FP = "filter_path=_scroll_id,hits.total,hits.hits._id"


def _rss_bytes() -> int:
    """This process's resident set now."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def scroll_ids(client, path: str, body: dict, label: str):
    """A whole scroll of `body` over `path`, pages of its `size`, only
    ids and the total read (`filter_path`): (ids in order, the total, the
    non-empty pages, the start's ms, each later page's ms). The last page
    must be empty; the context is cleared."""
    t = time.perf_counter()
    resp = client.ok("POST", f"{path}?scroll=1m&{SEARCH_API_FP}", body)
    start_ms = (time.perf_counter() - t) * 1e3
    total = resp["hits"]["total"]["value"]
    ids, pages, lat, sid = [], 0, [], resp["_scroll_id"]
    while True:
        page = [int(h["_id"]) for h in resp["hits"].get("hits", [])]
        if not page:
            break
        ids += page
        pages += 1
        t = time.perf_counter()
        resp = client.ok("POST", f"/_search/scroll?{SEARCH_API_FP}",
                         {"scroll_id": sid, "scroll": "1m"})
        lat.append((time.perf_counter() - t) * 1e3)
    freed = client.ok("DELETE", "/_search/scroll", {"scroll_id": sid})
    if freed["num_freed"] != 1:
        raise AssertionError(f"[search_api] {label}: clear {freed}")
    return np.asarray(ids, dtype=np.int64), total, pages, start_ms, lat


def _expect_once(label: str, ids: np.ndarray, want: np.ndarray) -> None:
    if len(np.unique(ids)) != len(ids) \
            or not np.array_equal(np.sort(ids), want):
        raise AssertionError(f"[search_api] {label}: {len(ids)} ids "
                             f"({len(np.unique(ids))} distinct) against "
                             f"numpy's {len(want)}")


def search_api_laion(client, node, cols) -> None:
    """Scroll on laion (serve_filtered's 1M x 512 index): a scroll of
    1,000 a page over the aesthetic_gte_6_5 filter (66,466 rows) returns
    every filtered row once, in 67 non-empty pages and then an empty one;
    a scroll sliced 4 ways (more slices than the index's one shard: each
    `_id`'s murmur3 hash) gives disjoint slices whose union is the same
    set; a `match_all` scroll start over every row. Logs one
    `[search_api] part=laion` line: the start's ms and the later pages'
    p50 (host clock), the slice hashing's ms over the index's ids, and the
    match_all start's ms, the process's RSS growth and the bytes of the
    context's arrays."""
    from elasticsearch_tpu_torch.search import service as search_service
    rows = np.nonzero(cols["aesthetic"] >= 6.5)[0]
    body = {"query": {"bool": {"filter": [
        {"range": {"aesthetic": {"gte": 6.5}}}]}}, "size": 1000}
    fields: dict = {"part": "laion", "filter_rows": len(rows)}
    ids, total, pages, start_ms, lat = scroll_ids(
        client, "/laion/_search", body, "scroll")
    _expect_once("scroll", ids, rows)
    if total != len(rows) or pages != -(-len(rows) // 1000):
        raise AssertionError(f"[search_api] scroll: total {total}, "
                             f"{pages} pages")
    fields.update(scroll_pages=pages, scroll_start_ms=f"{start_ms:.3f}",
                  scroll_page_p50_ms=f"{statistics.median(lat):.3f}")
    reader = node.index("laion").combined_reader()
    t = time.perf_counter()
    for view in reader.views:
        search_service.term_hashes(view.segment.ids)
    fields["slice_hash_ms"] = f"{(time.perf_counter() - t) * 1e3:.3f}"
    seen, starts = [], []
    for sid in range(4):
        part, _, _, s_ms, _ = scroll_ids(
            client, "/laion/_search", dict(body, slice={"id": sid,
                                                        "max": 4}),
            f"slice {sid}")
        seen.append(part)
        starts.append(s_ms)
    _expect_once("slices", np.concatenate(seen), rows)
    fields["slice_sizes"] = "/".join(str(len(p)) for p in seen)
    fields["slice_start_ms"] = "/".join(f"{s:.3f}" for s in starts)
    rss0 = _rss_bytes()
    t = time.perf_counter()
    resp = client.ok("POST", f"/laion/_search?scroll=1m&{SEARCH_API_FP}",
                     {"size": 1000})
    fields["match_all_start_ms"] = f"{(time.perf_counter() - t) * 1e3:.3f}"
    fields["match_all_rss_mb"] = f"{(_rss_bytes() - rss0) / 2**20:.1f}"
    fields["match_all_context_mb"] = f"{node.scrolls.nbytes() / 2**20:.1f}"
    if resp["hits"]["total"]["value"] != len(cols["aesthetic"]) \
            or len(resp["hits"]["hits"]) != 1000:
        raise AssertionError(f"[search_api] match_all: {resp['hits']}")
    client.ok("DELETE", "/_search/scroll/_all")
    log("search_api", **fields)


def search_api_sift(client, node, names, live, bvecs, qs) -> int:
    """`indices_boost`, `pinned` and a pinned scroll on sift (1M x 128,
    after serve_documents' writes: its exact legs) and sift_b (65,536+ x
    128, one clean generation after `_forcemerge`): a `knn` over
    `sift,sift_b` with `indices_boost: [{"sift_b": 2.0}]` is the stable
    merge by score of each index's own top 10, sift_b's scores doubled,
    and holds recall@10 >= 0.95 against numpy's merge of the two exact
    top 10s (each score within 2e-3 of numpy's); a `pinned` of three ids
    around a `knn` clause on sift returns them first, in order, then the
    `knn` body's own hits and scores; a scroll over a copy of sift_b does
    not see a write, a delete and a refresh made between its pages.
    Logs one `[search_api] part=sift` line; returns the bf16 binned
    launches (one a request that reaches sift_b's clean generation)."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    fields: dict = {"part": "sift", "requests_a_body": len(qs)}
    bnames = [f"b{i}" for i in range(len(bvecs))]

    def unit(m):
        return m / np.linalg.norm(m, axis=1, keepdims=True)

    ul, ub = unit(live), unit(bvecs)
    dispatch.reset_launches()
    lat, recalls = [], []
    for qi, qv in enumerate(qs):
        body = dict(knn_body("vec", qv), indices_boost=[{"sift_b": 2.0}])
        t = time.perf_counter()
        resp = client.ok("POST", "/sift,sift_b/_search", body)
        lat.append((time.perf_counter() - t) * 1e3)
        a = client.ok("POST", "/sift/_search",
                      knn_body("vec", qv))["hits"]["hits"]
        b = client.ok("POST", "/sift_b/_search",
                      knn_body("vec", qv))["hits"]["hits"]
        merged = sorted([(h["_score"], 0, j, h["_id"])
                         for j, h in enumerate(a)]
                        + [(2 * h["_score"], 1, j, h["_id"])
                           for j, h in enumerate(b)],
                        key=lambda e: (-e[0], e[1], e[2]))[:10]
        hits = resp["hits"]["hits"]
        if [h["_id"] for h in hits] != [e[3] for e in merged] or any(
                abs(h["_score"] - e[0]) > 1e-9 for h, e in zip(hits, merged)):
            raise AssertionError(f"[search_api] boost {qi}: {hits} against "
                                 f"{merged}")
        q = qv / np.linalg.norm(qv)
        sa = (1 + ul @ q) / 2
        sb = 2 * (1 + ub @ q) / 2
        ta, tb = np.argsort(-sa)[:10], np.argsort(-sb)[:10]
        cand = sorted([(sa[i], names[i]) for i in ta]
                      + [(sb[i], bnames[i]) for i in tb], reverse=True)[:10]
        truth = {nm: s for s, nm in cand}
        for h in hits:
            ref = truth.get(h["_id"])
            if ref is not None and abs(h["_score"] - ref) > 2e-3:
                raise AssertionError(f"[search_api] boost {qi}: {h} "
                                     f"against numpy {ref}")
        recalls.append(len(set(truth) & {h["_id"] for h in hits}) / 10)
    recall = float(np.mean(recalls))
    launched = dispatch.launches().get(kb.KERNEL_BF16, 0)
    if recall < 0.95 or launched != 2 * len(qs):
        raise AssertionError(f"[search_api] boost: recall@10 {recall}, "
                             f"{launched} launches")
    fields.update(boost_p50_ms=f"{statistics.median(lat):.3f}",
                  boost_recall_at_10=recall)
    launches = launched
    pins = [names[7], names[len(names) // 2], names[3]]
    lat = []
    for qi, qv in enumerate(qs):
        organic = {"field": "vec", "query_vector": qv.tolist(), "k": 10,
                   "num_candidates": 100}
        t = time.perf_counter()
        resp = client.ok("POST", "/sift/_search", {"query": {"pinned": {
            "ids": pins, "organic": {"knn": organic}}}, "size": 13,
            "_source": False})
        lat.append((time.perf_counter() - t) * 1e3)
        plain = client.ok("POST", "/sift/_search", dict(
            knn_body("vec", qv), _source=False))["hits"]["hits"]
        hits = resp["hits"]["hits"]
        rest = [(h["_id"], h["_score"]) for h in plain
                if h["_id"] not in pins]
        if [h["_id"] for h in hits[:3]] != pins \
                or [h["_id"] for h in hits[3:]] != [r[0] for r in rest] \
                or any(abs(h["_score"] - r[1]) > 1e-6
                       for h, r in zip(hits[3:], rest)) \
                or not hits[0]["_score"] > hits[1]["_score"] \
                > hits[2]["_score"] > hits[3]["_score"]:
            raise AssertionError(f"[search_api] pinned {qi}: {hits} "
                                 f"against {plain}")
    fields["pinned_p50_ms"] = f"{statistics.median(lat):.3f}"
    # a copy of sift_b: the later phases read sift_b as it is
    client.ok("PUT", "/sift_b_scroll", {
        "settings": {"number_of_shards": 1}, "mappings": {"properties": {
            "vec": {"type": "dense_vector", "dims": 128,
                    "similarity": "cosine"}}}})
    node.index("sift_b_scroll").index_many(
        [str(i) for i in range(len(bvecs))], vectors={"vec": bvecs})
    client.ok("POST", "/sift_b_scroll/_refresh")
    path = "/sift_b_scroll/_search"
    t = time.perf_counter()
    resp = client.ok("POST", f"{path}?scroll=1m&{SEARCH_API_FP}",
                     {"size": 1000})
    start_ms = (time.perf_counter() - t) * 1e3
    sid = resp["_scroll_id"]
    ids = [int(h["_id"]) for h in resp["hits"]["hits"]]
    ops = []
    for i in range(100):
        ops += [{"index": {"_id": str(len(bvecs) + i)}},
                {"vec": bvecs[i].tolist()},
                {"delete": {"_id": str(len(bvecs) - 1 - i)}}]
    if client.ok("POST", "/sift_b_scroll/_bulk", ops, ndjson=True)["errors"]:
        raise AssertionError("[search_api] scroll copy: bulk errors")
    client.ok("POST", "/sift_b_scroll/_refresh")
    lat = []
    while True:
        t = time.perf_counter()
        resp = client.ok("POST", f"/_search/scroll?{SEARCH_API_FP}",
                         {"scroll_id": sid})
        lat.append((time.perf_counter() - t) * 1e3)
        page = [int(h["_id"]) for h in resp["hits"].get("hits", [])]
        if not page:
            break
        ids += page
    _expect_once("scroll across a write", np.asarray(ids),
                 np.arange(len(bvecs)))
    if client.ok("POST", "/sift_b_scroll/_count")["count"] != len(bvecs):
        raise AssertionError("[search_api] scroll copy: count after writes")
    client.ok("DELETE", "/_search/scroll", {"scroll_id": sid})
    drop_index(client, "sift_b_scroll")
    fields.update(pinned_scroll_docs=len(bvecs),
                  pinned_scroll_start_ms=f"{start_ms:.3f}",
                  pinned_scroll_page_p50_ms=f"{statistics.median(lat):.3f}")
    log("search_api", **fields)
    return launches


def search_api_msmarco(client, name: str, tokens, doc_of, n: int) -> None:
    """The position kinds, `terms_set`, `wrapper` and `more_like_this` on
    msmarco (serve_hybrid's 262,144 passages of Zipf words `w<rank>`):
    `span_near` (two frequent words, slop 2, in order), `span_first` (end
    3), `intervals` (`match`, `ordered`, `max_gaps` 1), `terms_set` (at
    least `params.num_terms - 2` of four words), `wrapper` (a base64
    `match`): each total equal to the count over the generated token
    arrays (a token's position is its index in its passage; torch on the
    arrays' device), its first page in the reference's order;
    `more_like_this` of one passage's `_id` equal to the `bool.should` of
    the words selected there by the reference's tf * idf rule (tf >= 2,
    df >= 5, the top 25, 30% of them to match), less the liked passage.
    Logs one `[search_api] part=msmarco` line of HTTP p50s (DSL_REQUESTS
    each) and the oracle's seconds."""
    tok, doc = tokens.long(), doc_of.long()
    fields: dict = {"part": "msmarco", "docs": n,
                    "requests_a_body": DSL_REQUESTS}

    def host(t) -> np.ndarray:
        return t.cpu().numpy()

    def after(ra: int, rb: int, offsets) -> np.ndarray:
        """Passages holding rb at one of `offsets` positions after ra."""
        out = [doc[:0]]
        for d in offsets:
            hit = (tok[:-d] == ra) & (tok[d:] == rb) & (doc[:-d] == doc[d:])
            out.append(doc[:-d][hit])
        return host(torch.unique(torch.cat(out)))

    def docs_with(r: int) -> np.ndarray:
        return host(torch.unique(doc[tok == r]))

    t_oracle = time.perf_counter()
    # the arrays on the card: each token's passage, its position there
    bounds = torch.searchsorted(doc, torch.arange(n + 1, device=doc.device))
    pos = torch.arange(len(tok), device=tok.device) - bounds[doc]
    four = [10, 11, 12, 13]
    counts = np.bincount(np.concatenate([docs_with(r) for r in four]),
                         minlength=n)
    wrapped = {"match": {"body": "w20 w21"}}
    bodies = [
        ("span_near", {"span_near": {"clauses": [
            {"span_term": {"body": "w3"}}, {"span_term": {"body": "w5"}}],
            "slop": 2, "in_order": True}}, after(3, 5, (1, 2, 3))),
        ("span_first", {"span_first": {"match": {"span_term": {
            "body": "w4"}}, "end": 3}},
         host(torch.unique(doc[(tok == 4) & (pos <= 2)]))),
        ("intervals", {"intervals": {"body": {"match": {
            "query": "w6 w9", "ordered": True, "max_gaps": 1}}}},
         after(6, 9, (1, 2))),
        ("terms_set", {"terms_set": {"body": {
            "terms": [f"w{r}" for r in four],
            "minimum_should_match_script": {
                "source": "params.num_terms - 2"}}}},
         np.nonzero(counts >= 2)[0]),
        ("wrapper", {"wrapper": {"query": base64.b64encode(
            json.dumps(wrapped).encode()).decode()}},
         np.union1d(docs_with(20), docs_with(21))),
    ]
    # more_like_this: the first passage with three words of tf >= 2
    pairs = torch.unique(doc * MSMARCO_VOCAB + tok)
    df = host(torch.bincount(pairs % MSMARCO_VOCAB,
                             minlength=MSMARCO_VOCAB))
    head = host(tok[:bounds[min(n, 4096)]])
    cut = host(bounds[:min(n, 4096) + 1])
    liked = -1
    for d in range(len(cut) - 1):
        words, tf = np.unique(head[cut[d]:cut[d + 1]], return_counts=True)
        if ((tf >= 2) & (df[words] >= 5)).sum() >= 3:
            liked = d
            break
    scored = sorted(((float(f) * math.log(1 + (n - df[w] + 0.5)
                                          / (df[w] + 0.5)), "body", f"w{w}")
                     for w, f in zip(words.tolist(), tf.tolist())
                     if f >= 2 and df[w] >= 5), reverse=True)[:25]
    chosen = [int(t[2][1:]) for t in scored]
    hits_of = np.bincount(np.concatenate([docs_with(r) for r in chosen]),
                          minlength=n)
    need = max((len(chosen) * 30) // 100, 1)
    mlt = np.nonzero(hits_of >= need)[0]
    bodies.append(("more_like_this", {"more_like_this": {
        "fields": ["body"], "like": [{"_id": str(liked)}]}},
        mlt[mlt != liked]))
    fields["mlt_terms"] = len(chosen)
    fields["oracle_s"] = f"{time.perf_counter() - t_oracle:.1f}"
    for label, query, want_docs in bodies:
        resp = dsl_timed(client, f"/{name}/_search", label, {
            "query": query, "size": 10, "track_total_hits": True,
            "_source": False}, fields)
        hits = resp["hits"]
        got = [int(h["_id"]) for h in hits["hits"]]
        if hits["total"] != {"value": len(want_docs), "relation": "eq"} \
                or len(got) != min(10, len(want_docs)) \
                or not np.isin(got, want_docs).all():
            raise AssertionError(f"[search_api] {label}: total "
                                 f"{hits['total']}, hits {got}; numpy "
                                 f"{len(want_docs)}")
        _page_in_order(label, hits["hits"])
        fields[f"{label}_total"] = len(want_docs)
    log("search_api", **fields)


def search_api_logs(client, cols: dict) -> None:
    """The geo queries, `distance_feature` and a `terms` lookup on
    serve_logs (100,000 lines; `geoip.location` a `geo_point`, the 5% of
    lines without `geoip` holding none): `geo_distance` (200 km around
    Paris), `geo_bounding_box`, `geo_polygon` and `geo_shape` (an
    envelope) each with numpy's total and first page (every hit scores 1,
    so rows ascend); `distance_feature` on `@timestamp` (pivot 7 days)
    and on `geoip.location` (pivot 300 km): the top 10 numpy's (ties by
    row) and scores within 1e-5; a `terms` lookup through one stored
    document equal to the `terms` query written out. Logs one
    `[search_api] part=logs` line of HTTP p50s (DSL_REQUESTS each)."""
    city = cols["city"]
    has = city >= 0
    table = np.asarray([(c[2], c[3]) for c in LOGS_CITIES])
    lat = np.where(has, table[np.maximum(city, 0), 0], np.nan)
    lon = np.where(has, table[np.maximum(city, 0), 1], np.nan)

    def haversine(lat0, lon0):
        p1, p2 = np.radians(lat), np.radians(lat0)
        a = (np.sin((p2 - p1) / 2) ** 2 + np.cos(p1) * np.cos(p2)
             * np.sin(np.radians(lon0 - lon) / 2) ** 2)
        return 2 * 6371008.8 * np.arcsin(np.sqrt(np.clip(a, 0, 1)))

    def inside(points) -> np.ndarray:
        out = np.zeros(len(lat), dtype=bool)
        for (y1, x1), (y2, x2) in zip(points, points[1:] + points[:1]):
            with np.errstate(invalid="ignore"):
                cross = (y1 > lat) != (y2 > lat)
                xint = (x2 - x1) * (lat - y1) / (y2 - y1 + 1e-300) + x1
                out ^= cross & (lon < xint)
        return out & has

    fields: dict = {"part": "logs", "lines": len(city),
                    "requests_a_body": DSL_REQUESTS}
    paris = LOGS_CITIES[0]
    poly = [(55.0, -5.0), (55.0, 15.0), (38.0, 5.0)]
    with np.errstate(invalid="ignore"):
        masks = [
            ("geo_distance", {"geo_distance": {
                "distance": "200km", "geoip.location": {
                    "lat": paris[2], "lon": paris[3]}}},
             has & (haversine(paris[2], paris[3]) <= 200_000)),
            ("geo_bounding_box", {"geo_bounding_box": {"geoip.location": {
                "top_left": {"lat": 53.0, "lon": -1.0},
                "bottom_right": {"lat": 45.0, "lon": 14.0}}}},
             has & (lat <= 53) & (lat >= 45) & (lon >= -1) & (lon <= 14)),
            ("geo_polygon", {"geo_polygon": {"geoip.location": {
                "points": [{"lat": a, "lon": b} for a, b in poly]}}},
             inside(poly)),
            ("geo_shape", {"geo_shape": {"geoip.location": {"shape": {
                "type": "envelope",
                "coordinates": [[-10.0, 55.0], [20.0, 40.0]]}}}},
             has & (lon >= -10) & (lon <= 20) & (lat >= 40) & (lat <= 55)),
        ]
    for label, query, mask in masks:
        resp = dsl_timed(client, "/logs/_search", label, {
            "query": query, "size": 10, "track_total_hits": True,
            "_source": False}, fields)
        got = [int(h["_id"]) for h in resp["hits"]["hits"]]
        if resp["hits"]["total"]["value"] != int(mask.sum()) \
                or got != _top_rows(mask):
            raise AssertionError(f"[search_api] {label}: "
                                 f"{resp['hits']['total']} {got}; numpy "
                                 f"{int(mask.sum())} {_top_rows(mask)}")
        fields[f"{label}_total"] = int(mask.sum())
    origin = "1998-06-10T12:00:00Z"
    origin_ms = calendar.timegm((1998, 6, 10, 12, 0, 0)) * 1000
    pivot_ms = 7 * 86_400 * 1000.0
    ts_score = (pivot_ms / (pivot_ms + np.abs(cols["ts"] * 1000.0
                                              - origin_ms))
                ).astype(np.float32)
    pivot_m = 300_000.0
    with np.errstate(invalid="ignore"):
        geo_score = (pivot_m / (pivot_m + haversine(47.0, 3.0))
                     ).astype(np.float32)
    for label, query, score, keep in (
            ("distance_feature_date", {"distance_feature": {
                "field": "@timestamp", "origin": origin, "pivot": "7d"}},
             ts_score, np.ones(len(city), dtype=bool)),
            ("distance_feature_geo", {"distance_feature": {
                "field": "geoip.location", "origin": {"lat": 47.0,
                                                      "lon": 3.0},
                "pivot": "300km"}}, geo_score, has)):
        resp = dsl_timed(client, "/logs/_search", label, {
            "query": query, "size": 10, "_source": False}, fields)
        rows = np.nonzero(keep)[0]
        order = rows[np.lexsort((rows, -score[rows]))][:10]
        hits = resp["hits"]["hits"]
        if [int(h["_id"]) for h in hits] != order.tolist() or any(
                abs(h["_score"] - float(score[r])) > 1e-5
                for h, r in zip(hits, order)):
            raise AssertionError(f"[search_api] {label}: {hits} against "
                                 f"{order} {score[order]}")
    client.ok("PUT", "/logs_lookup/_doc/1?refresh=true",
              {"cities": ["Tokyo", "Rome"]})
    written = {"terms": {"geoip.city_name": ["Tokyo", "Rome"]}}
    lookup = {"terms": {"geoip.city_name": {
        "index": "logs_lookup", "id": "1", "path": "cities"}}}
    want = client.ok("POST", "/logs/_search", {
        "query": written, "track_total_hits": True})
    got = dsl_timed(client, "/logs/_search", "terms_lookup", {
        "query": lookup, "track_total_hits": True}, fields)
    tokyo_rome = int(np.isin(city, [6, 10]).sum())
    want.pop("took", None)
    if got != want or got["hits"]["total"]["value"] != tokyo_rome:
        raise AssertionError(f"[search_api] terms lookup: "
                             f"{got['hits']['total']} against "
                             f"{want['hits']['total']}, numpy {tokyo_rome}")
    fields["terms_lookup_total"] = tokyo_rome
    drop_index(client, "logs_lookup")
    log("search_api", **fields)


def _highlight_spans(label: str, frag: str, text: str):
    """The (start, end) offsets in `text` of the spans a highlight
    fragment wraps in <em> tags; taking the tags out must give back
    `text`."""
    spans, out, pos = [], [], 0
    for m in re.finditer(r"<em>(.*?)</em>", frag):
        plain = frag[pos:m.start()]
        out.append(plain)
        start = sum(map(len, out))
        out.append(m.group(1))
        spans.append((start, start + len(m.group(1))))
        pos = m.end()
    out.append(frag[pos:])
    _expect(f"{label} text", "".join(out), text)
    return spans


def _host_rrf_hits(legs, size: int = 10, rank_constant: int = 60):
    """The coordinator's RRF recomputed from the legs' `_search` hits:
    keyed on (_index, _id), sum(1 / (rank_constant + rank)), ties by the
    key, each hit as its first list rendered it. Returns (hits, total)."""
    fused, first = {}, {}
    for hits in legs:
        for rank, h in enumerate(hits):
            key = (h["_index"], h["_id"])
            fused[key] = fused.get(key, 0.0) + 1.0 / (rank_constant
                                                      + rank + 1)
            first.setdefault(key, h)
    ordered = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))
    return [dict(first[k], _score=v) for k, v in ordered[:size]], \
        len(fused)


def serve_body_msmarco(client, node, svc, q_text, q_emb, emb) -> int:
    """The search body's part on msmarco (serve_hybrid's index):
    BODY_HIGHLIGHTS `match` bodies with `highlight` on `body` (taking the
    tags out gives back the passage; every wrapped span analyzes to a
    query term; every token whose term is a query term is wrapped; no
    launch); then a second index `msmarco_b` of the first N_MSMARCO_B
    passages and BODY_HIGHLIGHTS `rank: {rrf}` bodies (`match` + `knn`)
    over `msmarco,msmarco_b`, each equal to the RRF the host recomputes
    from its legs' own `_search` responses over the same expression and
    launching the bf16 binned kernel once an index; and the same check on
    one-index bodies with `highlight` (the general path, one launch).
    Logs one `body` line; returns the binned launches."""
    name = svc.name
    mapper = svc.mapper_service.get("body")
    reader = svc.combined_reader()
    fields: dict = {"part": "msmarco", "requests_a_body": BODY_HIGHLIGHTS}
    exact = ExactRouteCounter()
    launches = 0
    wrapped = [0]
    try:
        def check_highlight(qi, resp):
            terms = set(mapper.search_analyzer.terms(q_text[qi]))
            hits = resp["hits"]["hits"]
            if not hits:
                raise AssertionError(f"serve_body highlight {qi}: no hits")
            for h in hits:
                text = reader.get_source(int(h["_id"]))["body"]
                spans = _highlight_spans(f"highlight {qi}",
                                         h["highlight"]["body"][0], text)
                for a, b in spans:
                    if mapper.analyzer.terms(text[a:b]) \
                            not in [[t] for t in terms]:
                        raise AssertionError(
                            f"serve_body highlight {qi}: span "
                            f"{text[a:b]!r} is no query term of {terms}")
                want = sorted({(t.start_offset, t.end_offset)
                               for t in mapper.analyzer.analyze(text)
                               if t.term in terms})
                _expect(f"highlight {qi} spans", sorted(spans), want)
                wrapped[0] += len(spans)

        launches += body_requests(
            client, f"/{name}/_search", "highlight",
            [{"query": {"match": {"body": t}}, "_source": False,
              "highlight": {"fields": {"body": {}}}}
             for t in q_text[:BODY_HIGHLIGHTS]],
            check_highlight, 0, exact, fields)
        fields["highlight_spans"] = wrapped[0]

        # the second index: the first passages again, with their vectors
        m = min(N_MSMARCO_B, reader.num_docs)
        client.ok("PUT", f"/{name}_b", {
            "settings": {"number_of_shards": 1},
            "mappings": svc.mapper_service.to_dict()})
        sources = []
        for i in range(m):
            src = reader.get_source(i)
            src.pop("emb", None)
            sources.append(src)
        node.index(f"{name}_b").index_many(
            [str(i) for i in range(m)], sources, vectors={"emb": emb[:m]})
        client.ok("POST", f"/{name}_b/_refresh")
        expr = f"{name},{name}_b"

        def legs_of(path, body):
            extra = {k: v for k, v in body.items()
                     if k in ("_source", "highlight")}
            return [client.ok("POST", path, dict(
                {"query": q, "size": 100}, **extra))["hits"]["hits"]
                for q in (body["query"], {"knn": body["knn"]})]

        def check_rrf(path, label, bodies):
            def check(qi, resp):
                want, total = _host_rrf_hits(legs_of(path, bodies[qi]))
                _expect(f"{label} {qi}", resp["hits"]["hits"], want)
                _expect(f"{label} {qi} total", resp["hits"]["total"],
                        {"value": total, "relation": "eq"})
                if "_shards" in resp:
                    raise AssertionError(f"serve_body {label}: the fused "
                                         f"path answered")
            return check

        bodies = [hybrid_body(t, qv) for t, qv in
                  zip(q_text[:BODY_HIGHLIGHTS], q_emb[:BODY_HIGHLIGHTS])]
        responses = []
        launches += body_requests(
            client, f"/{expr}/_search", "rrf_two_indices", bodies,
            lambda qi, resp: responses.append(resp), 2, exact, fields)
        for qi, resp in enumerate(responses):
            check_rrf(f"/{expr}/_search", "rrf_two_indices", bodies)(qi,
                                                                     resp)
        hl = [dict(b, highlight={"fields": {"body": {}}}) for b in bodies]
        responses = []
        launches += body_requests(
            client, f"/{name}/_search", "rrf_highlight", hl,
            lambda qi, resp: responses.append(resp), 1, exact, fields)
        for qi, resp in enumerate(responses):
            check_rrf(f"/{name}/_search", "rrf_highlight", hl)(qi, resp)
        fields["docs_b"] = m
        drop_index(client, f"{name}_b")
        log("body", **fields)
    finally:
        exact.close()
    return launches


def hybrid_repeat_pass(client, node, name: str, bodies, responses,
                       device: str) -> dict:
    """serve_hybrid's repeat pass, with the node's device rung of the
    request cache turned on: a cold pass over the bodies (each a miss
    that runs the path, one `bm25_board` and one binned launch a body,
    and stores its answer; its hits those of the phase's first pass),
    then a warm one (each a device-rung hit: no `bm25_board` and no
    binned launch, no board kernel, `took` 0, the cold response
    otherwise). Returns the cold pass's launches."""
    from elasticsearch_tpu_torch.ops import bm25, dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    cache = node.caches.device_request
    node.settings["search.request_cache.device_paths"] = "true"
    passes = {}
    try:
        for label in ("cold", "warm"):
            hits0, misses0 = cache.hits, cache.misses
            dispatch.reset_launches()
            kernels0 = bm25.kernel_launches() if device == "cuda" else 0
            lat, out = [], []
            for body in bodies:
                t = time.perf_counter()
                out.append(client.ok("POST", f"/{name}/_search", body))
                lat.append((time.perf_counter() - t) * 1e3)
            passes[label] = dict(
                lat=lat, out=out,
                launches={k: c for k, c in dispatch.launches().items() if c},
                hits=cache.hits - hits0, misses=cache.misses - misses0,
                board_kernels=(bm25.kernel_launches() - kernels0
                               if device == "cuda" else 0))
    finally:
        node.settings["search.request_cache.device_paths"] = "false"
    cold, warm = passes["cold"], passes["warm"]
    n = len(bodies)
    if (cold["hits"], cold["misses"]) != (0, n) or cold["launches"] != {
            bm25.KERNEL: n, kb.KERNEL_BF16: n}:
        raise AssertionError(f"serve_hybrid cold pass: {cold['hits']} hits, "
                             f"{cold['misses']} misses, launches "
                             f"{cold['launches']}")
    if (warm["hits"], warm["misses"]) != (n, 0) or warm["launches"] \
            or warm["board_kernels"]:
        raise AssertionError(f"serve_hybrid warm pass: {warm['hits']} hits, "
                             f"{warm['misses']} misses, launches "
                             f"{warm['launches']}, board kernels "
                             f"{warm['board_kernels']}")
    for i, (a, b) in enumerate(zip(cold["out"], warm["out"])):
        if a["hits"] != responses[i] or b["took"] != 0 or {
                k: v for k, v in a.items() if k != "took"} != {
                k: v for k, v in b.items() if k != "took"}:
            raise AssertionError(f"serve_hybrid repeat pass body {i}: the "
                                 f"cached response differs")
    log("serve_hybrid", cache="device_request", requests=n,
        cold_p50_ms=f"{statistics.median(cold['lat']):.3f}",
        warm_p50_ms=f"{statistics.median(warm['lat']):.3f}",
        device_request_hits=warm["hits"],
        device_request_misses=cold["misses"],
        warm_launches=json.dumps(warm["launches"]),
        warm_board_kernels=warm["board_kernels"])
    return cold["launches"]


def sparse_chunks(seed: int, n: int, dev):
    """Learned-sparse passages from `seed`: yields (first doc, token ids [T]
    int32 and weights [T] f32 on `dev`, tokens a passage [m] int64) chunks
    of SPARSE_CHUNK passages. A passage draws its SPARSE_DOC_TOKENS-bounded
    count (64 + an exponential of mean 56, cut at 256) of distinct tokens
    by Zipf popularity (Gumbel top-k over the ids), each with a weight in
    (0, 3]."""
    rng = np.random.default_rng(seed + 11)
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    p, _incl = sparse_popularity()
    logp = torch.from_numpy(np.log(p)).to(device=dev, dtype=torch.float32)
    lo_k, hi_k = SPARSE_DOC_TOKENS
    for lo in range(0, n, SPARSE_CHUNK):
        m = min(SPARSE_CHUNK, n - lo)
        counts = np.clip(lo_k + np.round(rng.exponential(
            SPARSE_MEAN_TOKENS - lo_k, m)), lo_k, hi_k).astype(np.int64)
        u = torch.rand((m, SPARSE_VOCAB), generator=g, device=dev)
        keys = logp[None, :] - torch.log(-torch.log(u))
        del u
        top = torch.topk(keys, hi_k, dim=1).indices
        del keys
        take = torch.arange(hi_k, device=dev)[None, :] \
            < torch.from_numpy(counts).to(dev)[:, None]
        toks = top[take].to(torch.int32)
        yield lo, toks, sparse_weights(g, len(toks), dev), counts


def sparse_body(tokens: dict, qv: np.ndarray, form: str = "sparse_vector"
                ) -> dict:
    """The learned-sparse hybrid body: a `sparse_vector` (or
    `weighted_tokens`) sub-search on `tokens` and a `knn` one on `emb`,
    fused by RRF."""
    leg = ({"sparse_vector": {"field": "tokens", "query_vector": tokens}}
           if form == "sparse_vector" else
           {"weighted_tokens": {"tokens": {"tokens": tokens}}})
    return {"sub_searches": [{"query": leg}, {"query": {"knn": {
        "field": "emb", "query_vector": qv.tolist(), "k": 10,
        "num_candidates": 100}}}], "rank": {"rrf": {}}, "size": 10,
        "_source": False}


def _same_window(label: str, got, want) -> None:
    """Rows and f32 bits equal: ((rows, scores), (rows, scores))."""
    (gr, gs), (wr, ws) = got, want
    if not (np.array_equal(gr, wr) and np.array_equal(
            np.asarray(gs, dtype=np.float32).view(np.int32),
            np.asarray(ws, dtype=np.float32).view(np.int32))):
        raise AssertionError(f"{label}: windows differ")


def phase_serve_sparse(seed: int, n: int, n_walker: int = N_SPARSE_WALKER,
                       device: str = "cuda") -> dict:
    """serve_sparse: learned-sparse retrieval over MS MARCO passage expanded
    by a BERT-wordpiece model (SPLADE, ELSER), hybrid with kNN by RRF, cut
    from 8,841,823 to `n` passages. One shard: `tokens` rank_features and
    `emb` 768-d cosine `flat` (the bf16 binned kernel); 1,000 passages
    over `_bulk`, the rest through `IndexService.index_many`, one refresh
    (the seal), the layout built (`SparseField.sync`). 64 queries of
    20-120 tokens (16 in the `weighted_tokens` form) and 8 of 257-300,
    each with its source passage's embedding plus noise. Gates: each
    sparse leg's window byte-identical to the host twin (`_score_host`);
    its top 10 against a float64 sparse dot over the generator's arrays
    (scipy CSR), a difference only among tied or 1-ulp scores at the cut;
    bf16 and int8 weights' recall@10 against it logged; the kNN leg's
    recall@10 >= 0.95; every response equal to host RRF of its legs (an
    empty token map too); one `bm25_board` call (variant `sparse`)
    and one binned launch a request, and at C = 1 and 8 one set a batch.
    Then the plain `query: {sparse_vector}` host walker on an index of
    the first `n_walker` passages, its hits byte-identical to the board's
    window there. Returns the launches."""
    import scipy.sparse

    from elasticsearch_tpu_torch.ops import bm25, dispatch, sparse
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    from elasticsearch_tpu_torch.search.hybrid_plan import compile_plan
    from elasticsearch_tpu_torch.server import build_server
    dev = torch.device(device)
    name, walk_name = "splade", "splade_walker"
    rng = np.random.default_rng(seed + 12)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    node, server = build_server(device=device, port=0,
                                settings=SERVE_SETTINGS)
    server.start()
    total = {bm25.KERNEL: 0, kb.KERNEL_BF16: 0}
    sparse_key = f"{bm25.KERNEL}/{sparse.VARIANT}"
    try:
        client = Client(server.port)
        index_body = {
            "settings": {"number_of_shards": 1},
            "mappings": {"properties": {
                "tokens": {"type": "rank_features"},
                "emb": {"type": "dense_vector", "dims": 768,
                        "similarity": "cosine",
                        "index_options": {"type": "flat"}}}}}
        client.ok("PUT", f"/{name}", index_body)
        svc = node.index(name)
        emb = clustered(rng, n, 768)
        tok_parts, w_parts, count_parts = [], [], []
        clock = {"data": 0.0, "ingest": 0.0}
        sources_of, walker_maps = {}, []
        n_query = 64
        first = min(1000, n)
        for lo, toks, weights, counts in sparse_chunks(seed, n, dev):
            t = time.perf_counter()
            host_t = toks.cpu().numpy()
            names = SPARSE_TOKENS[host_t].tolist()
            wl = weights.cpu().numpy().tolist()
            ends = np.cumsum(counts).tolist()
            maps = [dict(zip(names[e - c:e], wl[e - c:e]))
                    for e, c in zip(ends, counts.tolist())]
            for i in range(lo, lo + len(maps)):
                if i % (n // n_query + 1) == 7 or i % (n // 8 + 1) == 11:
                    e, c = ends[i - lo], int(counts[i - lo])
                    sources_of[i] = host_t[e - c:e].astype(np.int64)
            if lo < n_walker:
                walker_maps.extend(maps[:n_walker - lo])
            tok_parts.append(toks)
            w_parts.append(weights)
            count_parts.append(counts)
            clock["data"] += time.perf_counter() - t
            t = time.perf_counter()
            sources = [{"tokens": fm} for fm in maps]
            cut = max(first - lo, 0)
            if cut:
                ops = []
                for i in range(lo, lo + cut):
                    ops += [{"index": {"_id": str(i)}},
                            dict(sources[i - lo], emb=emb[i].tolist())]
                probe = dict(list(maps[7 - lo].items())[:5])

                def small_sparse(path):
                    hits = client.ok("POST", path, {
                        "query": {"sparse_vector": {
                            "field": "tokens", "query_vector": probe}},
                        "size": first, "_source": False})["hits"]["hits"]
                    if "7" not in {h["_id"] for h in hits}:
                        raise AssertionError(
                            f"small-index sparse_vector: {hits}")

                small_index_check(client, name, index_body, ops,
                                  small_sparse)
                if client.ok("POST", f"/{name}/_bulk", ops,
                             ndjson=True)["errors"]:
                    raise AssertionError("serve_sparse: bulk errors")
            if len(maps) > cut:
                svc.index_many([str(i) for i in range(lo + cut,
                                                      lo + len(maps))],
                               sources[cut:],
                               vectors={"emb": emb[lo + cut:lo + len(maps)]})
            clock["ingest"] += time.perf_counter() - t
            del maps, sources
        t = time.perf_counter()
        client.ok("POST", f"/{name}/_refresh")
        seal_s = time.perf_counter() - t
        counts_all = np.concatenate(count_parts)

        ex = node._hybrid_executor(svc)
        reader = svc.combined_reader()
        t = time.perf_counter()
        sf = ex.sparse.field(reader, "tokens")
        build_s = time.perf_counter() - t
        if sf.nnz != int(counts_all.sum()):
            raise AssertionError(f"serve_sparse: {sf.nnz} postings laid out "
                                 f"for {int(counts_all.sum())} generated")
        # postings a token holds: its valid lanes
        lane_cum = np.concatenate([[0], np.cumsum(
            (sf.tile_slots >= 0).sum(axis=1))])

        def postings(tokens):
            return sum(int(lane_cum[f + nt] - lane_cum[f]) for f, nt in
                       (sf.term_tiles[t] for t in tokens
                        if t in sf.term_tiles))

        # queries: 64 of 20-120 tokens, 8 of 257-300, from source passages
        p, _incl = sparse_popularity()
        srcs = sorted(i for i in sources_of if i % (n // n_query + 1) == 7)
        srcs = srcs[:n_query]
        wide_srcs = sorted(i for i in sources_of
                           if i % (n // 8 + 1) == 11)[:8]
        q_tokens = [sparse_query(rng, sources_of[i], int(rng.integers(
            *SPARSE_QUERY_TOKENS)), p) for i in srcs]
        q_tokens += [sparse_query(rng, sources_of[i], int(rng.integers(
            *SPARSE_WIDE_TOKENS)), p) for i in wide_srcs]
        n_main = len(srcs)
        q_src = srcs + wide_srcs
        q_emb = emb[q_src] + 0.3 * rng.standard_normal(
            (len(q_src), 768)).astype(np.float32)
        truth = exact_top(emb, q_emb, 10, "cosine")
        forms = ["weighted_tokens" if qi % 4 == 3 and qi < n_main
                 else "sparse_vector" for qi in range(len(q_tokens))]

        # the float64 oracle: the generator's arrays as a scipy CSR matrix
        t = time.perf_counter()
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts_all, out=indptr[1:])
        x = scipy.sparse.csr_matrix(
            (torch.cat(w_parts).cpu().numpy().astype(np.float64),
             torch.cat(tok_parts).cpu().numpy(), indptr),
            shape=(n, SPARSE_VOCAB))
        del tok_parts, w_parts
        qd = np.zeros((SPARSE_VOCAB, len(q_tokens)))
        for qi, toks in enumerate(q_tokens):
            for tname, w in toks.items():
                qd[int(tname[1:]), qi] = float(np.float32(w))
        s64_all = np.asarray(x @ qd)
        del x
        oracle_s = time.perf_counter() - t
        f64_top = []
        for qi in range(len(q_tokens)):
            # top 10 by (score desc, doc asc), from the best 64
            s64 = s64_all[:, qi]
            cand = np.argpartition(-s64, min(64, n - 1))[:64]
            f64_top.append(cand[np.lexsort((cand, -s64[cand]))][:10])

        # each sparse leg: byte-identical to the host twin; against f64
        leg_lat, ties, ulp_cuts, read = [], 0, 0, []
        legs_f32 = []
        for qi, toks in enumerate(q_tokens):
            t = time.perf_counter()
            (rows, scores), = ex.sparse.search_batch(
                reader, "tokens", [(toks, 1.0)], BM25_WINDOW)
            leg_lat.append((time.perf_counter() - t) * 1e3)
            _same_window(f"serve_sparse query {qi}: board against the "
                         f"host twin", (rows, scores),
                         sf.search_batch([(toks, 1.0)], BM25_WINDOW,
                                         route="host")[0])
            read.append(postings(toks))
            ties += int((np.diff(scores) == 0).sum())
            docs = np.asarray([int(reader.get_id(int(r))) for r in rows])
            legs_f32.append(docs[:10])
            s64 = s64_all[:, qi]
            top64 = f64_top[qi]
            top64 = top64[s64[top64] > 0]
            tenth = float(s64[top64[-1]])
            for doc in set(docs[:10].tolist()) ^ set(top64.tolist()):
                if abs(float(s64[doc]) - tenth) > 2e-6 * tenth:
                    raise AssertionError(
                        f"serve_sparse query {qi}: doc {doc} (f64 "
                        f"{float(s64[doc])}) against the f64 top 10's cut "
                        f"{tenth}")
                ulp_cuts += 1
            err = np.abs(scores[:10].astype(np.float64) - s64[docs[:10]])
            if (err > 1e-5 * np.abs(scores[:10])).any():
                raise AssertionError(f"serve_sparse query {qi}: f32 scores "
                                     f"{scores[:10]} off the f64 oracle")
        recall = {"f32": float(np.mean([
            len(set(a.tolist()) & set(b.tolist())) / 10
            for a, b in zip(legs_f32, f64_top)]))}
        tile_gb = {"f32": sf.nbytes() / 1e9}
        for dtype in ("bf16", "int8"):
            qf = sparse.SparseField("tokens", dtype, device=dev)
            for key in ("n_slots", "row_map", "term_tiles", "tile_slots",
                        "tile_impacts", "tile_first", "nnz", "version"):
                setattr(qf, key, getattr(sf, key))
            got = qf.search_batch([(q, 1.0) for q in q_tokens], 10)
            recall[dtype] = float(np.mean([
                len({int(reader.get_id(int(r))) for r in rows}
                    & set(want.tolist())) / 10
                for (rows, _s), want in zip(got, f64_top)]))
            tile_gb[dtype] = qf.nbytes() / 1e9
            del qf, got
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        del s64_all

        # hybrid requests over HTTP, each against host RRF of its legs
        bodies = [sparse_body(toks, qv, form)
                  for toks, qv, form in zip(q_tokens, q_emb, forms)]
        client.ok("POST", f"/{name}/_search", bodies[0])    # warm-up
        ex0 = dict(ex.stats)
        dispatch.reset_launches()
        kernels0 = bm25.kernel_launches() if device == "cuda" else 0
        lat, responses = [], []
        for body in bodies:
            t = time.perf_counter()
            responses.append(client.ok("POST", f"/{name}/_search",
                                       body)["hits"])
            lat.append((time.perf_counter() - t) * 1e3)
        launches = {k: c for k, c in dispatch.launches().items() if c}
        want = {bm25.KERNEL: len(bodies), kb.KERNEL_BF16: len(bodies)}
        if launches != want or dispatch.variant_launches().get(
                sparse_key, 0) != len(bodies):
            raise AssertionError(f"serve_sparse: launches {launches} "
                                 f"({dispatch.variant_launches()}) for "
                                 f"{len(bodies)} requests; expected {want}")
        if device == "cuda":
            # the board kernels the library launched: two a call
            board_kernels = bm25.kernel_launches() - kernels0
            if board_kernels != 2 * launches[bm25.KERNEL]:
                raise AssertionError(f"serve_sparse: {board_kernels} board "
                                     f"kernel launches for "
                                     f"{launches[bm25.KERNEL]} calls")
            log("serve_sparse", board_kernel_launches=board_kernels,
                board_calls=launches[bm25.KERNEL])
        for key, c in launches.items():
            total[key] += c
        stages = {k: (ex.stats[k] - ex0[k]) / len(bodies) / 1e6
                  for k in ("plan_nanos", "score_nanos", "fuse_nanos",
                            "hydrate_nanos")}
        extra = [sparse_body({}, q_emb[0]),
                 sparse_body({}, q_emb[1], "weighted_tokens")]
        host, knn_rows = [], []
        for bi, body in enumerate(bodies + extra):
            got = responses[bi] if bi < len(bodies) else \
                client.ok("POST", f"/{name}/_search", body)["hits"]
            plan = compile_plan(body, svc.mapper_service)
            legs = ex.score_legs(reader, [plan], [plan.bind(body)])[0]
            rows, scores = _host_rrf(legs)
            want_ids = [reader.get_id(r) for r in rows[:10]]
            if [h["_id"] for h in got["hits"]] != want_ids \
                    or [h["_score"] for h in got["hits"]] != scores[:10] \
                    or got["total"]["value"] != len(rows):
                raise AssertionError(f"serve_sparse body {bi}: differs from "
                                     f"host RRF of its legs")
            if bi < len(bodies):
                host.append((want_ids, scores[:10], len(rows)))
                knn_rows.append(legs[1][:10])
            elif len(legs[0]):
                raise AssertionError("serve_sparse: an empty token map gave "
                                     "sparse hits")
        knn_recall = float(np.mean([
            len({int(reader.get_id(int(r))) for r in rows}
                & set(tr.tolist())) / 10
            for rows, tr in zip(knn_rows, truth)]))
        if knn_recall < 0.95:
            raise AssertionError(f"serve_sparse kNN leg recall@10 "
                                 f"{knn_recall} < 0.95")

        # every body's legs as one batch: one board call
        dispatch.reset_launches()
        plans = [compile_plan(b, svc.mapper_service) for b in bodies]
        ex.score_legs(reader, plans, [pl.bind(b)
                                      for pl, b in zip(plans, bodies)])
        if dispatch.launches().get(bm25.KERNEL, 0) != 1 \
                or dispatch.variant_launches().get(sparse_key, 0) != 1:
            raise AssertionError(f"serve_sparse: {dispatch.launches()} for "
                                 f"one batch of {len(bodies)}")
        positions = [sum(t in sf.term_tiles for t in q) for q in q_tokens]
        fields = dict(
            docs=n, vocab=SPARSE_VOCAB, postings=sf.nnz,
            tokens_per_passage=f"{counts_all.mean():.2f}",
            tiles=len(sf.tile_slots),
            tile_gb=json.dumps({k: round(v, 3) for k, v in tile_gb.items()}),
            data_s=f"{clock['data']:.2f}", ingest_s=f"{clock['ingest']:.2f}",
            seal_s=f"{seal_s:.2f}", sparse_build_s=f"{build_s:.2f}",
            oracle_s=f"{oracle_s:.2f}", requests=len(bodies),
            query_tokens_mean=f"{np.mean([len(q) for q in q_tokens[:n_main]]):.1f}",
            wide_tokens_mean=f"{np.mean([len(q) for q in q_tokens[n_main:]]):.1f}",
            positions_per_query_mean=f"{np.mean(positions):.1f}",
            positions_per_query_max=max(positions),
            postings_per_query_mean=f"{np.mean(read):.0f}",
            shared_tokens_per_passage=f"{np.mean(read) / n:.3f}",
            hybrid_p50_ms=f"{statistics.median(lat):.3f}",
            sparse_leg_p50_ms=f"{statistics.median(leg_lat):.3f}",
            recall_at_10_vs_f64=json.dumps(recall),
            knn_recall_at_10=knn_recall, window_ties=ties,
            f64_cut_ulps=ulp_cuts,
            launches_per_request=json.dumps(
                {k: c / len(bodies) for k, c in launches.items()}))
        for stage, ms in stages.items():
            fields[f"{stage.split('_')[0]}_stage_ms"] = f"{ms:.4f}"
        if dev.type == "cuda":
            fields["device_peak_gb"] = \
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f}"
        fields["host_peak_rss_gb"] = f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9:.2f}"
        log("serve_sparse", **fields)

        # concurrent clients: batch-1 answers exactly, one set a batch
        def check(qi, payload):
            hits = payload["hits"]
            if hits["total"]["value"] != host[qi][2]:
                raise AssertionError(f"{name} query {qi}: total "
                                     f"{hits['total']} against {host[qi][2]}")
            return against_batch1(f"{name} query {qi}",
                                  [h["_id"] for h in hits["hits"]],
                                  [h["_score"] for h in hits["hits"]],
                                  host[qi][0], host[qi][1], 0.0)

        batches0 = ex.batcher.sched["batches"]
        conc = serve_concurrent(
            name, server.port, f"/{name}/_search", bodies[:n_main], (1, 8),
            2 * n_main, check, lambda: dict(ex.batcher.sched),
            (ex.batcher, "_dispatch_fn", 0),
            {f"{kb.KERNEL_BF16}/{kb.VARIANT_TMA}", sparse_key})
        batches = ex.batcher.sched["batches"] - batches0
        if conc.get(bm25.KERNEL, 0) != batches:
            raise AssertionError(f"serve_sparse concurrent: "
                                 f"{conc.get(bm25.KERNEL, 0)} bm25_board "
                                 f"calls for {batches} batches")
        for key, c in conc.items():
            total[key] = total.get(key, 0) + c
        log("serve_sparse", concurrent_batches=batches,
            sparse_calls=conc.get(bm25.KERNEL, 0))
        drop_index(client, name)
        del emb

        # the plain `query: {sparse_vector}` host walker, at n_walker
        client.ok("PUT", f"/{walk_name}", {
            "settings": {"number_of_shards": 1},
            "mappings": {"properties": {
                "tokens": {"type": "rank_features"}}}})
        wsvc = node.index(walk_name)
        wsvc.index_many([str(i) for i in range(len(walker_maps))],
                        [{"tokens": fm} for fm in walker_maps])
        client.ok("POST", f"/{walk_name}/_refresh")
        wex = node._hybrid_executor(wsvc)
        wreader = wsvc.combined_reader()
        dispatch.reset_launches()
        walk_lat, hits_of = [], []
        for qi, toks in enumerate(q_tokens):
            q = ({"sparse_vector": {"field": "tokens", "query_vector": toks}}
                 if forms[qi] == "sparse_vector" else
                 {"weighted_tokens": {"tokens": {"tokens": toks}}})
            t = time.perf_counter()
            hits_of.append(client.ok("POST", f"/{walk_name}/_search", {
                "query": q, "size": BM25_WINDOW,
                "_source": False})["hits"]["hits"])
            walk_lat.append((time.perf_counter() - t) * 1e3)
        if any(dispatch.launches().values()):
            raise AssertionError(f"serve_sparse: the host walker launched "
                                 f"{dispatch.launches()}")
        wboard_lat = []
        for qi, toks in enumerate(q_tokens):
            t = time.perf_counter()
            (rows, scores), = wex.sparse.search_batch(
                wreader, "tokens", [(toks, 1.0)], BM25_WINDOW)
            wboard_lat.append((time.perf_counter() - t) * 1e3)
            hits = hits_of[qi]
            _same_window(f"serve_sparse walker query {qi}: the board",
                         ([wreader.get_id(int(r)) for r in rows], scores),
                         ([h["_id"] for h in hits],
                          [h["_score"] for h in hits]))
        log("serve_sparse", walker_docs=len(walker_maps),
            walker_queries=len(q_tokens),
            walker_p50_ms=f"{statistics.median(walk_lat):.3f}",
            walker_board_leg_p50_ms=f"{statistics.median(wboard_lat):.3f}")
        drop_index(client, walk_name)
    finally:
        server.stop()
    return total


# --------------------------------------------------------------- serve_logs

N_LOGS = 100_000            # serve_logs lines (247,249,096 in the track)
N_LOGS_BULK = 2_000
N_LOGS_DYNAMIC = 10_000
N_LOGS_SPLIT = 20_000       # docs in each of the can_match pair's indices
LOGS_START = 893_894_400    # 1998-04-30T00:00:00Z
LOGS_DAYS = 88              # to 1998-07-26, the last day of the logs
LOGS_IPS = 200_000
LOGS_PATHS = 20_000
LOGS_STATUS = (200, 304, 404, 206, 302, 500, 403)
LOGS_STATUS_P = (0.86, 0.08, 0.03, 0.012, 0.008, 0.006, 0.004)
# (country, city, lat, lon); the last 5% of documents have no geoip
LOGS_CITIES = (
    ("France", "Paris", 48.8566, 2.3522), ("France", "Lyon", 45.764, 4.8357),
    ("United States", "New York", 40.7128, -74.006),
    ("United States", "Chicago", 41.8781, -87.6298),
    ("Brazil", "Sao Paulo", -23.5505, -46.6333),
    ("Germany", "Berlin", 52.52, 13.405), ("Japan", "Tokyo", 35.6762, 139.6503),
    ("Spain", "Madrid", 40.4168, -3.7038),
    ("United Kingdom", "London", 51.5074, -0.1278),
    ("Mexico", "Mexico City", 19.4326, -99.1332),
    ("Italy", "Rome", 41.9028, 12.4964),
    ("Netherlands", "Amsterdam", 52.3676, 4.9041))
# the Rally `http_logs` track's mapping (elastic/rally-tracks
# http_logs/index.json), `geoip` as an object of keyword names and a
# geo_point; "strict" reads as false, as the reference reads it, and
# `message`'s `index: false` is kept but not honoured (neither package
# reads it; the lines carry no `message`)
LOGS_MAPPING = {"dynamic": "strict", "properties": {
    "@timestamp": {"type": "date",
                   "format": "strict_date_optional_time||epoch_second"},
    "clientip": {"type": "ip"},
    "message": {"type": "keyword", "index": False, "doc_values": False},
    "request": {"type": "text", "fields": {"raw": {"type": "keyword",
                                                   "ignore_above": 256}}},
    "status": {"type": "integer"},
    "size": {"type": "integer"},
    "geoip": {"properties": {
        "country_name": {"type": "keyword"},
        "city_name": {"type": "keyword"},
        "location": {"type": "geo_point"}}}}}
LOGS_KINDS = ("day", "date_math", "term_raw", "ip_range", "sort_desc",
              "sort_asc", "docvalues", "exists")


def logs_paths() -> list:
    """The site's 20,000 request paths, most popular first."""
    sections = ("english", "french", "spanish", "german", "images")
    kinds = ("index_{}.html", "news_{}.html", "team_{}.gif",
             "match_{}.html", "photo_{}.jpg", "player_{}.html")
    return [f"/{sections[k % 5]}/{k // 5 % 97}/"
            + kinds[k % 6].format(k) for k in range(LOGS_PATHS)]


def _zipf(rng, n_items: int, n: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** s
    return rng.choice(n_items, n, p=p / p.sum())


def logs_columns(seed: int, n: int) -> dict:
    """The columns of n web-server log lines modelled on the Rally
    `http_logs` track (the 1998 World Cup site): `ts` epoch seconds over
    1998-04-30 to 1998-07-26, ascending, about 8 lines a second that has
    traffic; `ip` a Zipf draw (s = 1.1) over 200,000 IPv4 addresses
    (uint32); `path` a Zipf draw (s = 1.0) over 20,000 paths; `status`
    mostly 200, then 304, 404 and a few others; `size` log-normal bytes
    (0 for a 304); `city` an index of LOGS_CITIES, -1 (no geoip) for one
    line in 20."""
    rng = np.random.default_rng([seed, 18])
    n_sec = max(n // 8, 1)
    secs = np.sort(rng.choice(LOGS_DAYS * 86_400, n_sec, replace=False))
    ts = LOGS_START + np.sort(secs[rng.integers(0, n_sec, n)])
    pool = rng.choice(1 << 32, LOGS_IPS, replace=False).astype(np.uint32)
    status = np.asarray(LOGS_STATUS, dtype=np.int32)[
        rng.choice(len(LOGS_STATUS), n, p=LOGS_STATUS_P)]
    size = rng.lognormal(8.0, 1.5, n).astype(np.int64)
    size[status == 304] = 0
    city = rng.integers(0, len(LOGS_CITIES), n)
    city[rng.random(n) < 0.05] = -1
    return {"ts": ts.astype(np.int64), "ip": pool[_zipf(rng, LOGS_IPS, n,
                                                        1.1)],
            "path": _zipf(rng, LOGS_PATHS, n, 1.0).astype(np.int32),
            "status": status, "size": size, "city": city}


def ipv4(v: int) -> str:
    v = int(v)
    return f"{v >> 24}.{v >> 16 & 255}.{v >> 8 & 255}.{v & 255}"


def logs_sources(cols: dict, lo: int, hi: int, paths: list) -> list:
    """Documents lo..hi-1 as the track's JSON lines: its five fields, no
    `message`, as in its standard documents, and `geoip` as its ingest
    pipeline adds it."""
    out = []
    for i in range(lo, hi):
        ts, ip, st, sz = (int(cols["ts"][i]), ipv4(cols["ip"][i]),
                          int(cols["status"][i]), int(cols["size"][i]))
        req = f"GET {paths[cols['path'][i]]} HTTP/1.0"
        doc = {"@timestamp": ts, "clientip": ip, "request": req,
               "status": st, "size": sz}
        c = int(cols["city"][i])
        if c >= 0:
            country, city, lat, lon = LOGS_CITIES[c]
            doc["geoip"] = {"country_name": country, "city_name": city,
                            "location": {"lat": lat, "lon": lon}}
        out.append(doc)
    return out


def _iso(sec: int) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(int(sec)))


def _day(k: int) -> int:
    return LOGS_START + k * 86_400


def _top_rows(mask: np.ndarray, k: int = 10) -> list:
    """The first k matching rows: every hit of these bodies scores one
    constant, so the rows rank ascending."""
    return np.nonzero(mask)[0][:k].tolist()


def logs_requests(cols: dict, paths: list, seed: int, n_each: int) -> list:
    """n_each bodies of each kind, each with what numpy says it returns:
    (kind, body, want), want holding `total` (when the body tracks it),
    `ids` (the hits' `_id`s in order), `sort` (their sort values) and
    `fields` (their docvalue_fields). Rows are document numbers (the
    documents load in order into one shard)."""
    rng = np.random.default_rng([seed, 181])
    ts, n = cols["ts"], len(cols["ts"])
    ms = ts * 1000
    rows = np.arange(n)
    days = rng.integers(1, LOGS_DAYS - 1, size=8 * n_each)
    counts = np.bincount(cols["path"], minlength=LOGS_PATHS)
    rare = np.nonzero((counts >= 1) & (counts <= 3))[0]
    if not len(rare):
        rare = np.nonzero(counts >= 1)[0][-n_each:]
    out = []

    def add(kind, body, mask=None, ids=None, **want):
        if mask is not None:
            want["total"] = int(mask.sum())
            ids = _top_rows(mask, body.get("size", 10))
        want["ids"] = [str(i) for i in ids]
        out.append((kind, body, want))

    def in_day(k):
        return (ts >= _day(k)) & (ts < _day(k + 1))

    for j in range(n_each):
        k = int(days[j])
        add("day", {"query": {"range": {"@timestamp": {
            "gte": _iso(_day(k)), "lt": _iso(_day(k + 1))}}},
            "track_total_hits": True, "_source": False}, in_day(k))
        k = int(days[n_each + j])
        add("date_math", {"query": {"range": {"@timestamp": {
            "gte": _iso(_day(k))[:10] + "||-1d/d",
            "lte": _iso(_day(k))[:10] + "||/d"}}},
            "track_total_hits": True, "_source": False},
            (ts >= _day(k - 1)) & (ts < _day(k + 1)))
        path = int(rng.integers(0, 32)) if j % 2 == 0 \
            else int(rare[j % len(rare)])
        add("term_raw", {"query": {"term": {
            "request.raw": f"GET {paths[path]} HTTP/1.0"}},
            "track_total_hits": True, "_source": False},
            cols["path"] == path)
        lo = int(rng.integers(0, (1 << 32) - (1 << 22)))
        hi = lo + (1 << 22)
        add("ip_range", {"query": {"range": {"clientip": {
            "gte": ipv4(lo), "lt": ipv4(hi)}}},
            "track_total_hits": True, "_source": False},
            (cols["ip"] >= lo) & (cols["ip"] < hi))
        k = int(days[2 * n_each + j])
        add("exists", {"query": {"bool": {"filter": [
            {"exists": {"field": "geoip"}},
            {"range": {"@timestamp": {"gte": _iso(_day(k)),
                                      "lt": _iso(_day(k + 1))}}}]}},
            "track_total_hits": True, "_source": False},
            in_day(k) & (cols["city"] >= 0))
        k = int(days[3 * n_each + j])
        sel = np.nonzero(in_day(k))[0][:10]
        add("docvalues", {"query": {"range": {"@timestamp": {
            "gte": _iso(_day(k)), "lt": _iso(_day(k + 1))}}},
            "_source": False, "docvalue_fields": [
                {"field": "@timestamp",
                 "format": "strict_date_optional_time"},
                {"field": "@timestamp", "format": "epoch_millis"}]},
            ids=sel.tolist(), fields=[
                [time.strftime("%Y-%m-%dT%H:%M:%S.000Z",
                               time.gmtime(int(ts[i]))), str(int(ms[i]))]
                for i in sel])
        # a day's lines by time, five pages past the first through
        # search_after: desc on the timestamp alone (a page resumes
        # strictly below the last value, as the reference compares), asc
        # with `_doc` as the tie-break (every line once)
        for kind, sort in (("sort_desc", [{"@timestamp": "desc"}]),
                           ("sort_asc", [{"@timestamp": "asc"}, "_doc"])):
            k = int(days[(4 if kind == "sort_desc" else 5) * n_each + j])
            day = {"range": {"@timestamp": {"gte": _iso(_day(k)),
                                            "lt": _iso(_day(k + 1))}}}
            live = np.nonzero(in_day(k))[0]
            if kind == "sort_desc":
                live = live[np.lexsort((live, -ts[live]))]
            after = None
            for page in range(6):
                if after is not None:
                    cut = (ms[live] < after[0]) if kind == "sort_desc" \
                        else (ms[live] > after[0]) | (
                            (ms[live] == after[0]) & (live > after[1]))
                    live = live[cut]
                sel = live[:10]
                vals = [[int(ms[i])] if kind == "sort_desc"
                        else [int(ms[i]), int(i)] for i in sel]
                body = {"query": day, "sort": sort, "_source": False}
                if after is not None:
                    body["search_after"] = after
                add(kind, body, ids=sel.tolist(), sort=vals)
                if not len(sel):
                    break
                after = vals[-1]
    return out


def check_logs_response(kind: str, resp: dict, want: dict) -> None:
    hits = resp["hits"]["hits"]
    got = [h["_id"] for h in hits]
    if got != want["ids"]:
        raise AssertionError(f"serve_logs {kind}: ids {got[:10]}, numpy "
                             f"says {want['ids'][:10]}")
    if "total" in want and resp["hits"]["total"] != {
            "value": want["total"], "relation": "eq"}:
        raise AssertionError(f"serve_logs {kind}: total "
                             f"{resp['hits']['total']}, numpy says "
                             f"{want['total']}")
    if "sort" in want and [h["sort"] for h in hits] != want["sort"]:
        raise AssertionError(f"serve_logs {kind}: sort values "
                             f"{[h['sort'] for h in hits][:3]}, numpy says "
                             f"{want['sort'][:3]}")
    if "fields" in want and [h["fields"]["@timestamp"] for h in hits] \
            != want["fields"]:
        raise AssertionError(f"serve_logs {kind}: docvalue_fields "
                             f"{[h.get('fields') for h in hits][:2]}, "
                             f"Python says {want['fields'][:2]}")


LOGS_NAMES = ("ana", "bo", "chen", "dara", "eli", "femi", "gus", "hana",
              "ivo", "jun", "kai", "lea")
LOGS_EVENTS = ("login", "logout", "view", "click", "buy")


def dynamic_docs(seed: int, n: int) -> list:
    """Documents for a `dynamic: true` index: nested objects, dates as
    strings, ints, floats, bools and string arrays."""
    rng = np.random.default_rng([seed, 182])
    docs = []
    for i in range(n):
        c = LOGS_CITIES[int(rng.integers(len(LOGS_CITIES)))]
        docs.append({
            "user": {"name": LOGS_NAMES[int(rng.integers(len(LOGS_NAMES)))],
                     "age": int(rng.integers(16, 90)),
                     "score": float(np.round(rng.random() * 100, 3)),
                     "vip": bool(rng.random() < 0.1),
                     "address": {"city": c[1], "zip": f"{int(rng.integers(
                         10_000, 99_999))}"}},
            "event": {"at": _iso(_day(int(rng.integers(LOGS_DAYS)))
                                 + int(rng.integers(86_400))),
                      "kind": LOGS_EVENTS[int(rng.integers(5))],
                      "tags": [f"t{int(t)}" for t in rng.integers(0, 20, 2)]},
            "bytes": int(rng.integers(0, 1 << 20)),
            "seen": _iso(_day(int(rng.integers(LOGS_DAYS))))[:10]})
    return docs


def dynamic_mapping_of(doc: dict) -> dict:
    """The mapping the dynamic rules give a document: boolean, long,
    float, a `yyyy-MM-dd...` string as date, any other string as text
    with a `keyword` sub-field (ignore_above 256), an object as
    properties."""
    props = {}
    for k, v in doc.items():
        probe = v[0] if isinstance(v, list) else v
        if isinstance(v, dict):
            props[k] = dynamic_mapping_of(v)
        elif isinstance(probe, bool):
            props[k] = {"type": "boolean"}
        elif isinstance(probe, int):
            props[k] = {"type": "long"}
        elif isinstance(probe, float):
            props[k] = {"type": "float"}
        elif re.match(r"\d{4}-\d{2}-\d{2}", probe):
            props[k] = {"type": "date"}
        else:
            props[k] = {"type": "text", "fields": {"keyword": {
                "type": "keyword", "ignore_above": 256}}}
    return {"properties": props}


def logs_dynamic(client, seed: int, n: int) -> None:
    """A `dynamic: true` index of n documents over `_bulk`: `GET
    /_mapping` equals the dynamic rules' mapping, and `term` on a
    `.keyword` sub-field and a `range` on a dynamic date find what the
    documents say."""
    docs = dynamic_docs(seed, n)
    client.ok("PUT", "/logs_dynamic", {"settings": {"number_of_shards": 1},
                                       "mappings": {"dynamic": True}})
    t0 = time.perf_counter()
    for lo in range(0, n, 2000):
        ops = []
        for i in range(lo, min(lo + 2000, n)):
            ops += [{"index": {"_id": str(i)}}, docs[i]]
        if client.ok("POST", "/logs_dynamic/_bulk", ops,
                     ndjson=True)["errors"]:
            raise AssertionError("serve_logs: dynamic bulk errors")
    client.ok("POST", "/logs_dynamic/_refresh")
    bulk_s = time.perf_counter() - t0
    got = client.ok("GET", "/logs_dynamic/_mapping")["logs_dynamic"][
        "mappings"]
    want = dynamic_mapping_of(docs[0])
    if got != want:
        raise AssertionError(f"serve_logs: dynamic mapping {got}, the "
                             f"rules say {want}")
    checks = 0
    for field, of in (("user.name.keyword", lambda d: [d["user"]["name"]]),
                      ("event.tags.keyword", lambda d: d["event"]["tags"]),
                      ("user.address.city.keyword",
                       lambda d: [d["user"]["address"]["city"]])):
        for value in sorted({v for d in docs[:50] for v in of(d)})[:4]:
            want_n = sum(value in of(d) for d in docs)
            resp = client.ok("POST", "/logs_dynamic/_search", {
                "query": {"term": {field: value}}, "size": 0,
                "track_total_hits": True})
            if resp["hits"]["total"]["value"] != want_n:
                raise AssertionError(f"serve_logs: term {field}={value} "
                                     f"found {resp['hits']['total']}, the "
                                     f"documents say {want_n}")
            checks += 1
    k = LOGS_DAYS // 2
    want_n = sum(_iso(_day(k)) <= d["event"]["at"] < _iso(_day(k + 7))
                 for d in docs)
    resp = client.ok("POST", "/logs_dynamic/_search", {
        "query": {"range": {"event.at": {"gte": _iso(_day(k)),
                                         "lt": _iso(_day(k + 7))}}},
        "size": 0, "track_total_hits": True})
    if resp["hits"]["total"]["value"] != want_n:
        raise AssertionError(f"serve_logs: dynamic date range found "
                             f"{resp['hits']['total']}, want {want_n}")
    log("serve_logs", dynamic_docs=n, dynamic_bulk_s=f"{bulk_s:.2f}",
        dynamic_fields=sum(1 for _ in _leaf_paths(got)), term_checks=checks)
    drop_index(client, "logs_dynamic")


def _leaf_paths(mapping: dict, prefix: str = ""):
    for k, v in mapping.get("properties", {}).items():
        if "properties" in v:
            yield from _leaf_paths(v, f"{prefix}{k}.")
        else:
            yield prefix + k


def logs_can_match(client, node, cols: dict, paths: list,
                   n_each: int) -> dict:
    """Two time-partitioned indices (the first and the last N_LOGS_SPLIT
    lines, through `index_many` as the main index's bulk of lines): a
    day's range over both with `pre_filter_shard_size=1` skips
    the index whose dates miss the day (can_match reads the date bounds
    through the mapping) and counts what numpy counts. The indices stay
    for the aggregations; returns each one's line range."""
    n = len(cols["ts"])
    m = min(N_LOGS_SPLIT, n // 2)
    parts = {"logs_early": (0, m), "logs_late": (n - m, n)}
    for name, (lo, hi) in parts.items():
        client.ok("PUT", f"/{name}", {"settings": {"number_of_shards": 1},
                                      "mappings": LOGS_MAPPING})
        node.index(name).index_many([str(i) for i in range(lo, hi)],
                                    logs_sources(cols, lo, hi, paths))
        client.ok("POST", f"/{name}/_refresh")
    ts = cols["ts"]
    skipped, lat = 0, []
    first_day = (int(ts[n - m]) - LOGS_START) // 86_400 + 1
    for j in range(n_each):
        k = min(first_day + j % 4, LOGS_DAYS - 1)
        body = {"query": {"range": {"@timestamp": {
            "gte": _iso(_day(k)), "lt": _iso(_day(k + 1))}}},
            "size": 0, "track_total_hits": True}
        t = time.perf_counter()
        resp = client.ok("POST", "/logs_early,logs_late/_search"
                         "?pre_filter_shard_size=1", body)
        lat.append((time.perf_counter() - t) * 1e3)
        in_day = (ts >= _day(k)) & (ts < _day(k + 1))
        want = int(in_day[:m].sum() + in_day[n - m:].sum())
        if resp["hits"]["total"]["value"] != want \
                or resp["_shards"]["skipped"] != 1:
            raise AssertionError(f"serve_logs can_match: {resp['_shards']} "
                                 f"{resp['hits']['total']}, want {want} "
                                 f"and one skipped")
        skipped += resp["_shards"]["skipped"]
    log("serve_logs", can_match_requests=n_each, skipped_shards=skipped,
        can_match_p50_ms=f"{statistics.median(lat):.3f}")
    return parts


LOGS_AGG_REPS = 5           # device-rung requests a body (the p50's)
LOGS_AGG_HOST_REPS = 2      # host-path requests a body
# a p=12 HLL's standard error is 1.04 / sqrt(4096) = 1.6%: a cardinality
# may be off numpy's exact count by three of them
HLL_REL_BOUND = 3 * 1.04 / math.sqrt(4096)
LOGS_RANGES = [{"to": 1000}, {"from": 1000, "to": 10_000},
               {"from": 10_000, "to": 100_000}, {"from": 100_000}]


def logs_agg_bodies() -> dict:
    """label -> (path, body, device nodes, host nodes) of the aggregation
    part: a-f over `logs`, g over the can_match pair."""
    def day(aggs):
        return {"date_histogram": {"field": "@timestamp",
                                   "calendar_interval": "day"},
                "aggs": aggs}
    status = {"status": {"terms": {"field": "status"},
                         "aggs": {"size": {"stats": {"field": "size"}}}}}
    ip = {"cardinality": {"field": "clientip"}}
    bodies = {
        "a": {"by_hour": {"date_histogram": {"field": "@timestamp",
                                             "calendar_interval": "hour"}}},
        "b": status,
        "c": {"daily": day({"status": {"terms": {"field": "status"}}})},
        "d": {"sizes": {"range": {"field": "size", "ranges": LOGS_RANGES},
                        "aggs": {"avg": {"avg": {"field": "size"}}}}},
        "e": {"ips": ip, "daily": day({"ips": ip})},
        "f": {"pct": {"percentiles": {"field": "size"}},
              "kinds": {"filters": {"filters": {
                  "errors": {"range": {"status": {"gte": 400}}},
                  "empty": {"term": {"size": 0}}}}},
              "no_geo": {"missing": {"field": "geoip.city_name"}},
              "all": {"global": {}, "aggs": {"max": {"max": {
                  "field": "size"}}}}},
    }
    out = {k: ("/logs/_search", {"size": 0, "aggs": v}, len(v), 0)
           for k, v in bodies.items()}
    out["f"] = out["f"][:2] + (0, 4)
    out["g"] = ("/logs_early,logs_late/_search",
                {"size": 0, "aggs": status}, 2, 0)
    return out


def _stats_of(v: np.ndarray) -> dict:
    return {"count": int(len(v)), "min": float(v.min()),
            "max": float(v.max()), "avg": float(int(v.sum())) / len(v),
            "sum": float(int(v.sum()))}


def check_logs_aggs(label: str, aggs: dict, cols: dict, sel) -> float:
    """Body `label`'s aggregations against numpy over the lines `sel`
    (an index array); returns the largest relative cardinality error."""
    ts, st, sz = cols["ts"][sel], cols["status"][sel], cols["size"][sel]

    def expect(what, got, want):
        if got != want:
            raise AssertionError(f"serve_logs aggs {label} {what}: "
                                 f"{str(got)[:300]}, numpy says "
                                 f"{str(want)[:300]}")
    worst = 0.0
    if label == "a":
        keys, counts = np.unique(ts // 3600 * 3_600_000, return_counts=True)
        expect("by_hour", [(b["key"], b["doc_count"])
                           for b in aggs["by_hour"]["buckets"]],
               list(zip(keys.tolist(), counts.tolist())))
    elif label in ("b", "g"):
        codes, counts = np.unique(st, return_counts=True)
        order = sorted(zip(codes.tolist(), counts.tolist()),
                       key=lambda kc: (-kc[1], kc[0]))
        expect("status", [(b["key"], b["doc_count"], b["size"])
                          for b in aggs["status"]["buckets"]],
               [(c, k, _stats_of(sz[st == c])) for c, k in order])
    elif label == "c":
        days = ts // 86_400
        got = {(b["key"], s["key"]): s["doc_count"]
               for b in aggs["daily"]["buckets"]
               for s in b["status"]["buckets"]}
        pairs, counts = np.unique(np.stack([days, st]), axis=1,
                                  return_counts=True)
        expect("daily status", got,
               {(int(d) * 86_400_000, int(c)): int(k)
                for (d, c), k in zip(pairs.T.tolist(), counts.tolist())})
    elif label == "d":
        want = []
        for r in LOGS_RANGES:
            m = (sz >= r.get("from", -np.inf)) & (sz < r.get("to", np.inf))
            want.append((int(m.sum()), float(int(sz[m].sum())) / m.sum()))
        expect("sizes", [(b["doc_count"], b["avg"]["value"])
                         for b in aggs["sizes"]["buckets"]], want)
    elif label == "e":
        ip = cols["ip"][sel]
        exact = [(aggs["ips"]["value"], len(np.unique(ip)))]
        days = ts // 86_400
        for b in aggs["daily"]["buckets"]:
            d = b["key"] // 86_400_000
            exact.append((b["ips"]["value"], len(np.unique(ip[days == d]))))
        for got, want in exact:
            err = abs(got - want) / max(want, 1)
            worst = max(worst, err)
            if err > HLL_REL_BOUND:
                raise AssertionError(f"serve_logs aggs e: cardinality {got}"
                                     f", numpy's exact count {want}")
    elif label == "f":
        kinds = aggs["kinds"]["buckets"]
        expect("filters", (kinds["errors"]["doc_count"],
                           kinds["empty"]["doc_count"]),
               (int((st >= 400).sum()), int((sz == 0).sum())))
        expect("missing", aggs["no_geo"]["doc_count"],
               int((cols["city"][sel] < 0).sum()))
        expect("global", (aggs["all"]["doc_count"],
                          aggs["all"]["max"]["value"]),
               (len(ts), float(sz.max())))
    return worst


def logs_aggs(client, node, cols: dict, parts: dict) -> dict:
    """The aggregation part of serve_logs (`logs_agg_bodies`), each body
    with the device rung forced (`search.aggs.cost_router` false), on the
    host path (`search.aggs.device_enabled` false) and under the default
    router, every request with `request_cache: false` but the cache
    repeat. Returns the `aggs.*` op calls of the part."""
    from elasticsearch_tpu_torch.ops import dispatch
    n = len(cols["ts"])
    svc = node.index("logs")
    dev = node.device
    launches0 = dispatch.launches()
    node.settings.update({"search.aggs.device_enabled": "true",
                          "search.aggs.cost_router": "false"})
    # the columns the bodies read, built and uploaded once
    engine = node._agg_engine(svc)
    reader = svc.combined_reader()
    t0 = time.perf_counter()
    snap = engine.store.snapshot(reader)
    for field, want_ords in (("@timestamp", False), ("status", True),
                             ("size", False), ("clientip", True)):
        engine.store.column(reader, field, want_ords=want_ords,
                            snap=snap).device_arrays(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sel_of = {"g": np.concatenate([np.arange(*parts["logs_early"]),
                                   np.arange(*parts["logs_late"])])}
    line = {"column_build_s": f"{build_s:.3f}"}
    worst = 0.0
    for label, (path, body, n_dev, n_host) in logs_agg_bodies().items():
        body = dict(body, request_cache=False)
        lat = {"dev": [], "host": []}
        answers = {}
        for mode, reps in (("dev", LOGS_AGG_REPS),
                           ("host", LOGS_AGG_HOST_REPS)):
            node.settings["search.aggs.device_enabled"] = \
                "true" if mode == "dev" else "false"
            for _ in range(reps):
                before = node.aggs_stats()
                t = time.perf_counter()
                resp = client.ok("POST", path, body)
                lat[mode].append((time.perf_counter() - t) * 1e3)
                after = node.aggs_stats()
                if mode == "dev" and (
                        after["device_nodes"] - before["device_nodes"]
                        != n_dev
                        or after["host_nodes"] - before["host_nodes"]
                        != n_host):
                    raise AssertionError(
                        f"serve_logs aggs {label}: device nodes "
                        f"{after['device_nodes'] - before['device_nodes']}"
                        f", host nodes "
                        f"{after['host_nodes'] - before['host_nodes']}, "
                        f"want {n_dev} and {n_host}: "
                        f"{after['fallback_reasons']}")
                answers[mode] = json.dumps(resp["aggregations"],
                                           sort_keys=True)
        if answers["dev"] != answers["host"]:
            raise AssertionError(f"serve_logs aggs {label}: the device "
                                 f"rung's answer differs from the host "
                                 f"path's")
        worst = max(worst, check_logs_aggs(
            label, json.loads(answers["dev"]), cols,
            sel_of.get(label, np.arange(n))))
        line[f"{label}_dev_p50_ms"] = f"{statistics.median(lat['dev']):.3f}"
        line[f"{label}_host_p50_ms"] = \
            f"{statistics.median(lat['host']):.3f}"
    # hourly_agg through the request cache: the repeat hits, runs no op
    node.settings["search.aggs.device_enabled"] = "true"
    path, body, _, _ = logs_agg_bodies()["a"]
    first = client.ok("POST", path, body)
    before, ops_before = node.aggs_stats(), dispatch.launches()
    hits = node.caches.request.stats()["hit_count"]
    again = client.ok("POST", path, body)
    if again["aggregations"] != first["aggregations"] \
            or node.caches.request.stats()["hit_count"] != hits + 1 \
            or node.aggs_stats()["device_nodes"] != before["device_nodes"] \
            or dispatch.launches() != ops_before:
        raise AssertionError("serve_logs aggs: the cached hourly_agg ran "
                             "on the card or missed")
    # the default cost router at this size: the device nodes of two
    # requests a body against the eligible ones
    node.settings["search.aggs.cost_router"] = "true"
    routes = []
    for label, (path, body, n_dev, _) in logs_agg_bodies().items():
        before = node.aggs_stats()["device_nodes"]
        for _ in range(2):
            client.ok("POST", path, dict(body, request_cache=False))
        routes.append(f"{label}:{node.aggs_stats()['device_nodes'] - before}"
                      f"/{2 * n_dev}")
    node.settings.update({"search.aggs.device_enabled": "true",
                          "search.aggs.cost_router": "false"})
    got = dispatch.launches()
    calls = {k: got[k] - launches0.get(k, 0) for k in got
             if k.startswith("aggs.") and got[k] != launches0.get(k, 0)}
    if dev.type == "cuda" and not calls:
        raise AssertionError("serve_logs aggs: no aggs.* op on the card")
    log("aggs", **line, router_device_nodes=",".join(routes),
        hll_worst_rel_err=f"{worst:.4f}",
        hll_bound=f"{HLL_REL_BOUND:.4f}",
        op_calls=json.dumps(calls, sort_keys=True).replace(" ", ""))
    if dev.type == "cuda":
        logs_agg_ops(engine, reader, snap, calls)
    return calls


# ------------------------------------------------------------- aggs_kinds
#
# The aggregation kinds of the rest of the layer over serve_logs' `logs`
# index and its can_match pair: pipelines over the device rung's daily
# histogram, composite paging, rare and significant terms, the geo grids,
# top_hits / top_metrics, the other metrics, scripts and the remaining
# bucket kinds, each answer held to numpy over `logs_columns`.

AGGS_KINDS_REPS = 16        # requests a body (the p50's)
# floats derived by sums in another order (means, centroids, moments)
KINDS_REL = 1e-9
# t-digest answers over the pair (two indices' merged digests, compression
# 200 over 40,000 sizes): a percentile rank within half a percent, a
# quartile within 2% of numpy's exact one
TD_RANK_ABS = 0.5
TD_QUANTILE_REL = 0.02
_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def _close(a, b, rel=KINDS_REL) -> bool:
    if a is None or b is None:
        return a is b
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


def _geohash(lat: float, lon: float, precision: int) -> str:
    """A geohash by interleaved bisection, longitude first."""
    lo = [-90.0, -180.0]
    hi = [90.0, 180.0]
    v = [lat, lon]
    out, bits, n = [], 0, 0
    for i in range(precision * 5):
        d = 1 - i % 2       # even bits bisect the longitude
        mid = (lo[d] + hi[d]) / 2
        bit = int(v[d] >= mid)
        if bit:
            lo[d] = mid
        else:
            hi[d] = mid
        bits = bits * 2 + bit
        n += 1
        if n == 5:
            out.append(_BASE32[bits])
            bits, n = 0, 0
    return "".join(out)


def _geotile(lat: float, lon: float, z: int) -> str:
    """The web-map tile z/x/y of a point."""
    n = 1 << z
    lat = min(max(lat, -85.05112878), 85.05112878)
    r = math.radians(lat)
    x = int((lon + 180.0) / 360.0 * n)
    y = int((1.0 - math.log(math.tan(r) + 1 / math.cos(r)) / math.pi)
            / 2.0 * n)
    return f"{z}/{min(max(x, 0), n - 1)}/{min(max(y, 0), n - 1)}"


def _kinds_expect(label: str, what: str, ok: bool, got, want) -> None:
    if not ok:
        raise AssertionError(f"aggs_kinds {label} {what}: "
                             f"{str(got)[:300]}, numpy says "
                             f"{str(want)[:300]}")


def _daily(ts, sz):
    """[(day key ms, count, avg size)] of the days holding lines (a
    calendar histogram fills no gap)."""
    days = ts // 86_400
    keys, counts = np.unique(days, return_counts=True)
    sums = np.bincount(np.searchsorted(keys, days), weights=sz)
    return [(int(k) * 86_400_000, int(c), float(int(s)) / int(c))
            for k, c, s in zip(keys.tolist(), counts.tolist(),
                               sums.tolist())]


def _check_siblings(label, aggs, daily) -> None:
    avgs = [a for _, _, a in daily if a is not None]
    want_avg = sum(avgs) / len(avgs)
    mx = max(avgs)
    _kinds_expect(label, "avg_bucket", _close(aggs["avg_daily"]["value"],
                                              want_avg),
                  aggs["avg_daily"], want_avg)
    keys = [str(k) for k, _, a in daily if a == mx]
    _kinds_expect(label, "max_bucket",
                  _close(aggs["max_daily"]["value"], mx)
                  and aggs["max_daily"]["keys"] == keys,
                  aggs["max_daily"], (mx, keys))
    arr = np.asarray(avgs)
    for p in (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0):
        got = aggs["pct_daily"]["values"][str(p)]
        want = float(np.percentile(arr, p))
        _kinds_expect(label, f"percentiles_bucket {p}", _close(got, want),
                      got, want)


def composite_pages(send, path, sources, size, pages=None) -> list:
    """The buckets of a composite's pages, following `after_key` to the
    end (or `pages` pages); `send(path, body)` answers a search."""
    out, after, k = [], None, 0
    while pages is None or k < pages:
        spec = {"sources": sources, "size": size}
        if after is not None:
            spec["after"] = after
        comp = send(path, {"size": 0, "request_cache": False,
                           "aggs": {"c": {"composite": spec}}}
                    )["aggregations"]["c"]
        if not comp["buckets"]:
            break
        out += comp["buckets"]
        after = comp["after_key"]
        k += 1
    return out


def _hdr_value(v_sorted: np.ndarray, p: float, digits: int) -> float:
    """HDR's highest equivalent value of the value at the rank."""
    n = len(v_sorted)
    rank = min(max(int(np.floor(p / 100.0 * n + 0.5)), 1), n)
    x = float(v_sorted[rank - 1])
    if x <= 0:
        return x
    sub = 2 ** int(np.ceil(np.log2(10.0 ** max(digits, 1))))
    vmin = float(v_sorted[v_sorted > 0][0])
    unit = 2.0 ** np.floor(np.log2(vmin)) / sub
    erange = max(2.0 ** np.floor(np.log2(x)) / sub, unit)
    return float(np.floor(x / erange) * erange + erange - unit)


def aggs_kinds_bodies(cols: dict) -> dict:
    """label -> (path, body) of the [aggs_kinds] part."""
    day = {"date_histogram": {"field": "@timestamp",
                              "calendar_interval": "day"}}
    siblings = {
        "daily": {**day, "aggs": {"avg_size": {"avg": {"field": "size"}}}},
        "avg_daily": {"avg_bucket": {"buckets_path": "daily>avg_size"}},
        "max_daily": {"max_bucket": {"buckets_path": "daily>avg_size"}},
        "pct_daily": {"percentiles_bucket": {
            "buckets_path": "daily>avg_size"}}}
    geo = {"b": {"geo_bounds": {"field": "geoip.location"}},
           "c": {"geo_centroid": {"field": "geoip.location"}}}
    out = {
        "pipelines": {**siblings, "top_days": {"bucket_sort": {
            "buckets_path": {"a": "daily>avg_size"},
            "sort": [{"avg_size": "desc"}], "size": 10}}},
        "parents": {"daily": {**day, "aggs": {
            "avg_size": {"avg": {"field": "size"}},
            "deriv": {"derivative": {"buckets_path": "avg_size"}},
            "cum": {"cumulative_sum": {"buckets_path": "_count"}},
            "mov": {"moving_fn": {
                "buckets_path": "avg_size", "window": 7,
                "script": "MovingFunctions.unweightedAvg(values)"}}}}},
        "composite_day_status": {"c": {"composite": {"size": 100, "sources": [
            {"day": day}, {"status": {"terms": {"field": "status"}}}]}}},
        "composite_ip": {"c": {"composite": {"size": 100, "sources": [
            {"ip": {"terms": {"field": "clientip"}}}]}}},
        "rare_significant": {
            "rare": {"rare_terms": {"field": "clientip"}}},
        "significant": {"sig": {"significant_terms": {"field": "status"}}},
        "geo_grids": {
            "tiles": {"geotile_grid": {"field": "geoip.location",
                                       "precision": 6}, "aggs": geo},
            "hashes": {"geohash_grid": {"field": "geoip.location",
                                        "precision": 4}, "aggs": geo}},
        "top_hits_metrics": {"st": {"terms": {"field": "status"}, "aggs": {
            "big": {"top_hits": {"size": 3, "sort": [{"size": "desc"}]}},
            "last": {"top_metrics": {"metrics": {"field": "size"},
                                     "sort": {"@timestamp": "desc"}}}}}},
        "metrics": {
            "w": {"weighted_avg": {"value": {"field": "size"},
                                   "weight": {"field": "status"}}},
            "pr": {"percentile_ranks": {"field": "size",
                                        "values": [1000, 10000, 100000]}},
            "mad": {"median_absolute_deviation": {"field": "size"}},
            "box": {"boxplot": {"field": "size"}},
            "hdr": {"percentiles": {"field": "size", "hdr": {
                "number_of_significant_value_digits": 3}}},
            "ss": {"string_stats": {"field": "request.raw"}},
            "mx": {"matrix_stats": {"fields": ["size", "status"]}}},
        "scripts": {
            "s": {"terms": {"script": {"source": "doc['status'].value"}}},
            "bytes": {"scripted_metric": {
                "init_script": "state.b = 0",
                "map_script": "state.b += doc['size'].value",
                "combine_script": "return state.b",
                "reduce_script": "double s = 0; for (x in states) "
                                 "{ s += x } return s"}}},
        "other_buckets": {
            "auto": {"auto_date_histogram": {"field": "@timestamp",
                                             "buckets": 10}},
            "adj": {"adjacency_matrix": {"filters": {
                "err": {"range": {"status": {"gte": 400}}},
                "big": {"range": {"size": {"gte": 100_000}}},
                "paris": {"term": {"geoip.city_name": "Paris"}}}}},
            "samp": {"sampler": {"shard_size": 200}, "aggs": {
                "st": {"terms": {"field": "status"}}}}},
        "pair_composite": {"c": {"composite": {"size": 100, "sources": [
            {"day": day}, {"status": {"terms": {"field": "status"}}}]}}},
        "pair_siblings": siblings,
        "pair_digests": {
            "pr": {"percentile_ranks": {"field": "size",
                                        "values": [1000, 10000, 100000]}},
            "box": {"boxplot": {"field": "size"}},
            "b": {"geo_bounds": {"field": "geoip.location"}}},
    }
    queries = {"significant": {"range": {"status": {"gte": 400}}},
               "scripts": {"term": {"status": 404}}}
    bodies = {}
    for label, aggs in out.items():
        path = "/logs_early,logs_late/_search" if label.startswith("pair") \
            else "/logs/_search"
        body = {"size": 0, "request_cache": False, "aggs": aggs}
        if label in queries:
            body["query"] = queries[label]
        bodies[label] = (path, body)
    return bodies


def check_aggs_kinds(label: str, aggs: dict, cols: dict, sel: np.ndarray,
                     paths: list) -> None:
    """Body `label`'s answer against numpy over the lines `sel`."""
    ts, st, sz = cols["ts"][sel], cols["status"][sel], cols["size"][sel]
    ip, city = cols["ip"][sel], cols["city"][sel]
    ms = ts * 1000
    if label in ("pipelines", "pair_siblings"):
        daily = _daily(ts, sz)
        _check_siblings(label, aggs, daily)
        buckets = aggs["daily"]["buckets"]
        top = daily if label == "pair_siblings" else sorted(
            daily, key=lambda d: d[2], reverse=True)[:10]
        got = [(b["key"], b["doc_count"], b["avg_size"]["value"])
               for b in buckets]
        _kinds_expect(label, "daily", len(got) == len(top) and all(
            g[:2] == w[:2] and _close(g[2], w[2]) for g, w in zip(got, top)),
            got, top)
    elif label == "parents":
        daily = _daily(ts, sz)
        cum, prev = 0.0, None
        for i, (b, (k, c, a)) in enumerate(zip(aggs["daily"]["buckets"],
                                               daily)):
            cum += c
            win = [d[2] for d in daily[max(0, i - 7):i] if d[2] is not None]
            want = {"key": k, "doc_count": c, "avg": a, "cum": cum,
                    "deriv": (a - prev if prev is not None and a is not None
                              else None),
                    "mov": sum(win) / len(win) if win else None}
            got = {"key": b["key"], "doc_count": b["doc_count"],
                   "avg": b["avg_size"]["value"], "cum": b["cum"]["value"],
                   "deriv": b.get("deriv", {}).get("value"),
                   "mov": b["mov"]["value"]}
            _kinds_expect(label, f"day {k}", got["key"] == k
                          and got["doc_count"] == c and all(
                              _close(got[f], want[f])
                              for f in ("avg", "cum", "deriv", "mov")),
                          got, want)
            prev = a
        _kinds_expect(label, "days", len(aggs["daily"]["buckets"])
                      == len(daily), len(aggs["daily"]["buckets"]),
                      len(daily))
    elif label in ("composite_day_status", "pair_composite"):
        pairs, counts = np.unique(np.stack([ts // 86_400, st]), axis=1,
                                  return_counts=True)
        want = [{"key": {"day": int(d) * 86_400_000, "status": int(s)},
                 "doc_count": int(c)}
                for (d, s), c in zip(pairs.T.tolist(), counts.tolist())]
        _kinds_expect(label, "pages", aggs["pages"] == want,
                      aggs["pages"][:5], want[:5])
    elif label == "composite_ip":
        texts, counts = np.unique(np.asarray([ipv4(v) for v in ip]),
                                  return_counts=True)
        want = [{"key": {"ip": t}, "doc_count": int(c)}
                for t, c in zip(texts.tolist(), counts.tolist())][:300]
        _kinds_expect(label, "three pages", aggs["pages"] == want,
                      aggs["pages"][:5], want[:5])
    elif label == "rare_significant":
        vals, counts = np.unique(ip, return_counts=True)
        rare = vals[counts == 1]
        want = [ipv4(v) for v in rare[:10]]
        got = aggs["rare"]
        _kinds_expect(label, "rare_terms",
                      [b["key"] for b in got["buckets"]] == want
                      and all(b["doc_count"] == 1 for b in got["buckets"])
                      and got["sum_other_doc_count"]
                      == max(len(rare) - 10, 0),
                      got, want)
    elif label == "significant":
        # sel is the foreground (status >= 400); the background every line
        bg_codes, bg_counts = np.unique(cols["status"], return_counts=True)
        bg = dict(zip(bg_codes.tolist(), bg_counts.tolist()))
        fg_codes, fg_counts = np.unique(st, return_counts=True)
        fg_total, bg_total = len(st), len(cols["status"])
        want = []
        for code, fg in zip(fg_codes.tolist(), fg_counts.tolist()):
            fq, bq = fg / fg_total, bg[code] / bg_total
            if fg >= 3 and fq > bq:
                want.append((code, fg, bg[code], (fq - bq) * (fq / bq)))
        want.sort(key=lambda w: (-w[3], w[0]))
        got = [(b["key"], b["doc_count"], b["bg_count"], b["score"])
               for b in aggs["sig"]["buckets"]]
        _kinds_expect(label, "significant_terms",
                      aggs["sig"]["doc_count"] == fg_total
                      and aggs["sig"]["bg_count"] == bg_total
                      and len(got) == len(want) and all(
                          g[:3] == w[:3] and _close(g[3], w[3])
                          for g, w in zip(got, want)), got, want)
    elif label == "geo_grids":
        has = city >= 0
        lat = np.asarray([LOGS_CITIES[c][2] for c in city[has]])
        lon = np.asarray([LOGS_CITIES[c][3] for c in city[has]])
        for name, enc, prec in (("tiles", _geotile, 6),
                                ("hashes", _geohash, 4)):
            keys = np.asarray([enc(la, lo, prec)
                               for la, lo in zip(lat.tolist(), lon.tolist())])
            cells, counts = np.unique(keys, return_counts=True)
            order = sorted(zip(cells.tolist(), counts.tolist()),
                           key=lambda kc: (-kc[1], kc[0]))
            got = aggs[name]["buckets"]
            _kinds_expect(label, name, [(b["key"], b["doc_count"])
                                        for b in got] == order, got, order)
            for b in got:
                m = keys == b["key"]
                box = b["b"]["bounds"]
                ok = (box["top_left"] == {"lat": float(lat[m].max()),
                                          "lon": float(lon[m].min())}
                      and box["bottom_right"] == {
                          "lat": float(lat[m].min()),
                          "lon": float(lon[m].max())}
                      and b["c"]["count"] == int(m.sum())
                      and _close(b["c"]["location"]["lat"],
                                 float(lat[m].mean()))
                      and _close(b["c"]["location"]["lon"],
                                 float(lon[m].mean())))
                _kinds_expect(label, f"{name} {b['key']}", ok, b, m.sum())
    elif label == "top_hits_metrics":
        rows = sel
        for b in aggs["st"]["buckets"]:
            mine = rows[st == b["key"]]
            order = mine[np.lexsort((mine, -cols["size"][mine]))][:3]
            want = [(str(r), [int(cols["size"][r])]) for r in order]
            got = [(h["_id"], h["sort"]) for h in b["big"]["hits"]["hits"]]
            _kinds_expect(label, f"top_hits {b['key']}", got == want
                          and b["big"]["hits"]["total"]["value"]
                          == len(mine), got, want)
            last = mine[cols["ts"][mine] == cols["ts"][mine].max()].max()
            want = [{"sort": [float(cols["ts"][last] * 1000)],
                     "metrics": {"size": float(cols["size"][last])}}]
            _kinds_expect(label, f"top_metrics {b['key']}",
                          b["last"]["top"] == want, b["last"], want)
    elif label == "metrics":
        v = np.sort(sz.astype(np.float64))
        n = len(v)
        w = float((sz * st).sum()) / float(st.sum())
        _kinds_expect(label, "weighted_avg", _close(aggs["w"]["value"], w),
                      aggs["w"], w)
        for t in (1000, 10000, 100000):
            want = 100.0 * np.searchsorted(v, t, side="right") / n
            got = aggs["pr"]["values"][f"{float(t)}"]
            _kinds_expect(label, f"percentile_rank {t}", _close(got, want),
                          got, want)
        med = np.median(v)
        mad = float(np.median(np.abs(v - med)))
        _kinds_expect(label, "mad", _close(aggs["mad"]["value"], mad),
                      aggs["mad"], mad)
        q1, q2, q3 = (float(np.percentile(v, p)) for p in (25, 50, 75))
        iqr = q3 - q1
        inside = v[(v >= q1 - 1.5 * iqr) & (v <= q3 + 1.5 * iqr)]
        box = {"min": float(v[0]), "max": float(v[-1]), "q1": q1,
               "q2": q2, "q3": q3, "lower": float(inside.min()),
               "upper": float(inside.max())}
        _kinds_expect(label, "boxplot", aggs["box"].keys() == box.keys()
                      and all(_close(aggs["box"][k], box[k]) for k in box),
                      aggs["box"], box)
        for p in (1, 5, 25, 50, 75, 95, 99):
            want = _hdr_value(v, float(p), 3)
            got = aggs["hdr"]["values"][f"{float(p)}"]
            _kinds_expect(label, f"hdr {p}", _close(got, want), got, want)
        reqs = [f"GET {paths[p]} HTTP/1.0" for p in cols["path"][sel]]
        lens = np.asarray([len(r) for r in reqs])
        chars = np.frombuffer("".join(reqs).encode("ascii"), dtype=np.uint8)
        freq = np.bincount(chars)
        prob = freq[freq > 0] / len(chars)
        ent = float(-(prob * np.log2(prob)).sum())
        ss = aggs["ss"]
        _kinds_expect(label, "string_stats", ss["count"] == len(reqs)
                      and ss["min_length"] == int(lens.min())
                      and ss["max_length"] == int(lens.max())
                      and _close(ss["avg_length"], float(lens.mean()))
                      and abs(ss["entropy"] - ent) < 1e-9, ss, ent)
        x = np.stack([sz.astype(np.float64), st.astype(np.float64)])
        cov = np.cov(x)
        sd = np.sqrt(np.diag(cov))
        for i, f in enumerate(aggs["mx"]["fields"]):
            c = x[i] - x[i].mean()
            want = {"mean": x[i].mean(), "variance": cov[i, i],
                    "skewness": float(((c / sd[i]) ** 3).mean()),
                    "kurtosis": float(((c / sd[i]) ** 4).mean()),
                    "cov": cov[i, 1 - i],
                    "corr": cov[i, 1 - i] / (sd[0] * sd[1])}
            other = "status" if f["name"] == "size" else "size"
            got = {"mean": f["mean"], "variance": f["variance"],
                   "skewness": f["skewness"], "kurtosis": f["kurtosis"],
                   "cov": f["covariance"][other],
                   "corr": f["correlation"][other]}
            _kinds_expect(label, f"matrix_stats {f['name']}",
                          f["count"] == n and all(
                              _close(got[k], want[k]) for k in want),
                          got, want)
    elif label == "scripts":
        want = float(int(sz.sum()))
        _kinds_expect(label, "terms script (the reference keys no bucket "
                             "on a script)", aggs["s"]["buckets"] == [],
                      aggs["s"], [])
        _kinds_expect(label, "scripted_metric",
                      _close(aggs["bytes"]["value"], want),
                      aggs["bytes"], want)
    elif label == "other_buckets":
        span = float(ms.max() - ms.min())
        interval = max(max(span, 1.0) / 10, 1.0)
        for unit in (1, 1000, 60_000, 3_600_000, 86_400_000, 2_592_000_000,
                     31_536_000_000):
            if interval <= unit:
                interval = unit
                break
        keys, counts = np.unique(np.floor(ms / interval) * interval,
                                 return_counts=True)
        got = [(b["key"], b["doc_count"]) for b in aggs["auto"]["buckets"]
               if b["doc_count"]]
        want = [(int(k), int(c)) for k, c in zip(keys.tolist(),
                                                 counts.tolist())]
        _kinds_expect(label, "auto_date_histogram", got == want
                      and aggs["auto"]["interval"] == f"{int(interval)}ms",
                      aggs["auto"], want)
        masks = {"err": st >= 400, "big": sz >= 100_000,
                 "paris": city == 0}
        want = []
        names = sorted(masks)
        for i, a in enumerate(names):
            if masks[a].sum():
                want.append((a, int(masks[a].sum())))
            for b in names[i + 1:]:
                both = int((masks[a] & masks[b]).sum())
                if both:
                    want.append((f"{a}&{b}", both))
        got = [(b["key"], b["doc_count"]) for b in aggs["adj"]["buckets"]]
        _kinds_expect(label, "adjacency_matrix", got == want, got, want)
        first = st[:200]    # the sampler's rows: the first lines
        codes, counts = np.unique(first, return_counts=True)
        want = sorted(zip(codes.tolist(), counts.tolist()),
                      key=lambda kc: (-kc[1], kc[0]))
        got = [(b["key"], b["doc_count"])
               for b in aggs["samp"]["st"]["buckets"]]
        _kinds_expect(label, "sampler", aggs["samp"]["doc_count"]
                      == len(first) and got == want, got, want)
    elif label == "pair_digests":
        v = np.sort(sz.astype(np.float64))
        for t in (1000, 10000, 100000):
            want = 100.0 * np.searchsorted(v, t, side="right") / len(v)
            got = aggs["pr"]["values"][f"{float(t)}"]
            _kinds_expect(label, f"percentile_rank {t}",
                          abs(got - want) <= TD_RANK_ABS, got, want)
        for q, p in (("q1", 25), ("q2", 50), ("q3", 75)):
            want = float(np.percentile(v, p))
            got = aggs["box"][q]
            _kinds_expect(label, f"boxplot {q}",
                          abs(got - want) <= TD_QUANTILE_REL * abs(want),
                          got, want)
        _kinds_expect(label, "boxplot min/max", (aggs["box"]["min"],
                                                 aggs["box"]["max"])
                      == (v[0], v[-1]), aggs["box"], (v[0], v[-1]))
        has = city[city >= 0]
        lat = [LOGS_CITIES[c][2] for c in np.unique(has)]
        lon = [LOGS_CITIES[c][3] for c in np.unique(has)]
        want = {"top_left": {"lat": max(lat), "lon": min(lon)},
                "bottom_right": {"lat": min(lat), "lon": max(lon)}}
        _kinds_expect(label, "geo_bounds", aggs["b"]["bounds"] == want,
                      aggs["b"], want)


def aggs_kinds_sel(label: str, cols: dict, parts: dict) -> np.ndarray:
    """The lines a body's answer covers: the pair's, the foreground of
    the significant / script bodies, or every line."""
    n = len(cols["ts"])
    if label.startswith("pair"):
        return np.concatenate([np.arange(*parts["logs_early"]),
                               np.arange(*parts["logs_late"])])
    if label == "significant":
        return np.nonzero(cols["status"] >= 400)[0]
    if label == "scripts":
        return np.nonzero(cols["status"] == 404)[0]
    return np.arange(n)


def with_pages(label: str, path: str, body: dict, aggs: dict,
               send) -> dict:
    """A composite body's answer as its pages (to the end; three for
    `clientip`), the first of them the answer given."""
    if "composite" not in label:
        return aggs
    comp = aggs["c"]
    pages = composite_pages(send, path,
                            body["aggs"]["c"]["composite"]["sources"], 100,
                            pages=3 if label == "composite_ip" else None)
    if pages[:len(comp["buckets"])] != comp["buckets"]:
        raise AssertionError(f"aggs_kinds {label}: the first page differs "
                             f"from the timed one")
    return {"pages": pages}


def logs_aggs_kinds(client, node, cols: dict, parts: dict,
                    paths: list) -> None:
    """The [aggs_kinds] part of serve_logs: each body of
    `aggs_kinds_bodies` AGGS_KINDS_REPS times over HTTP with the device
    rung on (router off) and `request_cache: false`, its answer held to
    numpy (`check_aggs_kinds`); a composite's first page is the timed
    body, then its pages to the end (three for `clientip`). The
    pipelines body must run its daily histogram on the device rung (one
    device node a request, `aggs.*` launches counted, the profile's
    engine) with the pipelines over its output; the parents body is one
    host node (`unsupported_sub_agg`). Logs each body's HTTP p50 and the
    part's seconds."""
    from elasticsearch_tpu_torch.ops import dispatch
    t_part = time.perf_counter()
    node.settings.update({"search.aggs.device_enabled": "true",
                          "search.aggs.cost_router": "false"})
    line = {}
    for label, (path, body) in aggs_kinds_bodies(cols).items():
        lat = []
        for _ in range(AGGS_KINDS_REPS):
            before, ops0 = node.aggs_stats(), dispatch.launches()
            t = time.perf_counter()
            resp = client.ok("POST", path, body)
            lat.append((time.perf_counter() - t) * 1e3)
            after, ops1 = node.aggs_stats(), dispatch.launches()
            dev = after["device_nodes"] - before["device_nodes"]
            host = after["host_nodes"] - before["host_nodes"]
            if label == "pipelines":
                agg_ops = sum(c - ops0.get(k, 0) for k, c in ops1.items()
                              if k.startswith("aggs."))
                if dev != 1 or host != 0 or (
                        agg_ops == 0 and node.device.type == "cuda"):
                    raise AssertionError(
                        f"aggs_kinds pipelines: device nodes {dev}, host "
                        f"nodes {host}, aggs.* launches {agg_ops}")
            elif label == "parents":
                reasons = (after["fallback_reasons"].get(
                    "unsupported_sub_agg", {}).get("count", 0)
                    - before["fallback_reasons"].get(
                        "unsupported_sub_agg", {}).get("count", 0))
                if dev != 0 or host != 1 or reasons != 1:
                    raise AssertionError(
                        f"aggs_kinds parents: device nodes {dev}, host "
                        f"nodes {host}, unsupported_sub_agg {reasons}")
        aggs = with_pages(label, path, body, resp["aggregations"],
                          lambda p, b: client.ok("POST", p, b))
        check_aggs_kinds(label, aggs, cols, aggs_kinds_sel(label, cols,
                                                           parts), paths)
        line[f"{label}_p50_ms"] = f"{statistics.median(lat):.3f}"
    # the pipelines read the device rung's daily histogram: its profile
    path, body = aggs_kinds_bodies(cols)["pipelines"]
    prof = client.ok("POST", path, dict(body, profile=True))["profile"]
    engines = {e["description"]: e.get("engine")
               for e in prof["shards"][0]["aggregations"]}
    if engines != {"daily": "device", "avg_daily": None, "max_daily": None,
                   "pct_daily": None, "top_days": None}:
        raise AssertionError(f"aggs_kinds pipelines profile: {engines}")
    log("aggs_kinds", reps=AGGS_KINDS_REPS, **line,
        part_s=f"{time.perf_counter() - t_part:.1f}")


def logs_agg_ops(engine, reader, snap, calls: dict) -> None:
    """Each `aggs.*` op at the shapes the bodies gave it over every line
    (match_all), timed a call with CUDA events beside its byte bound
    (every row's inputs read once over the card's memory rate) and, for
    `ord_counts`, one `torch.bincount` of the same lanes."""
    from elasticsearch_tpu_torch.ops import aggs as ops
    dev = engine.device
    store = engine.store
    r = snap.r_pad
    mask = torch.from_numpy(snap.filter_mask(snap.row_map)).to(dev)
    ts = store.column(reader, "@timestamp", snap=snap)
    st = store.column(reader, "status", want_ords=True, snap=snap)
    sz = store.column(reader, "size", snap=snap)
    ip = store.column(reader, "clientip", want_hll=True, snap=snap)
    tk, tp = ts.device_arrays(dev)[:2]
    so = st.device_arrays(dev)[2]
    sv, sp = sz.device_arrays(dev)[:2]
    hidx, hrho = ip.device_arrays(dev)[3:]
    b_st = ops.bucket_count(len(st.ord_keys))

    def cal(unit):
        real, _tz = engine._calendar_bounds("@timestamp", ts, unit, None,
                                            0.0, 1.0)
        b = ops.bucket_count(len(real))
        cb = np.full(b, np.inf)
        cb[:len(real)] = real
        return torch.from_numpy(cb).to(dev), b
    hour, b_hour = cal("H")
    daycb, b_day = cal("D")
    base = math.floor(sz.vmin / 10_000)
    b_hist = ops.bucket_count(math.floor(sz.vmax / 10_000) - base + 1)
    hp = (10_000.0, 0.0, float(base), 1.0, None)
    bounds = np.full((8, 2), np.inf)
    for i, rg in enumerate(LOGS_RANGES):
        bounds[i] = (rg.get("from", -np.inf), rg.get("to", np.inf))
    bt = torch.from_numpy(bounds).to(dev)
    levels = [("cal", b_day, (tk, tp, daycb, (1.0, 0.0))),
              ("ord", b_st, (so, False))]
    lanes = torch.where(mask & (so >= 0), so.long(), b_st)
    cases = {
        "ord_counts": (lambda: ops.ord_counts(so, mask, b_st), 5,
                       lambda: torch.bincount(lanes, minlength=b_st + 1)),
        "ord_metric": (lambda: ops.ord_metric(so, mask, None, sv, sp, b_st),
                       14, None),
        "hist_counts": (lambda: ops.hist_counts(sv, sp, mask, hp, b_hist),
                        10, None),
        "hist_metric": (lambda: ops.hist_metric(sv, sp, mask, hp, None, sv,
                                                sp, b_hist), 19, None),
        "range_counts": (lambda: ops.range_counts(sv, sp, mask, bt, None),
                         10, None),
        "range_metric": (lambda: ops.range_metric(sv, sp, mask, bt, None,
                                                  None, sv, sp), 19, None),
        "cal_counts": (lambda: ops.cal_counts(tk, tp, mask, hour, (1.0, 0.0),
                                              b_hour), 10, None),
        "cal_metric": (lambda: ops.cal_metric(tk, tp, mask, hour, (1.0, 0.0),
                                              None, sv, sp, b_hour), 19,
                       None),
        "tree_counts": (lambda: ops.tree_counts(mask, levels), 14, None),
        "tree_metric": (lambda: ops.tree_metric(mask, None, sv, sp, levels),
                        23, None),
        "hll_board": (lambda: ops.hll_board(mask, hidx, hrho, levels[:1]),
                      18, None),
    }
    for name, (fn, row_bytes, library) in cases.items():
        ms = time_ms(fn, iters=10, warmup=2)
        bound, _ = bound_ms(row_bytes * r, 0, 1.0)
        log("aggs_op", name=f"aggs.{name}", rows=r,
            launches=calls.get(f"aggs.{name}", 0), ms=f"{ms:.4f}",
            bound_ms=f"{bound:.4f}", bound_by="bytes",
            library_ms=(f"{time_ms(library, iters=10, warmup=2):.4f}"
                        if library is not None else "null"))


def phase_serve_logs(seed: int, n: int, device: str = "cuda",
                     n_each: int = 64,
                     n_dynamic: int = N_LOGS_DYNAMIC,
                     node_apis_only: bool = False) -> dict:
    """serve_logs: a web-server log index modelled on the Rally
    `http_logs` track (247,249,096 lines of the 1998 World Cup site; its
    index.json mapping, LOGS_MAPPING), cut to `n` lines for host ingest
    and the run's time: N_LOGS_BULK lines over `_bulk`, the rest through
    `IndexService.index_many(sources=)`, one refresh. n_each requests of
    each LOGS_KINDS kind over HTTP, each answer held to numpy over the
    generated columns (`logs_requests`); then the dynamic index
    (`logs_dynamic`), the can_match pair (`logs_can_match`) and the
    aggregations over both (`logs_aggs`). Logged: ingest seconds, the
    parse rate (lines a second through `index_many`), the refresh, the
    host APIs of the `[node_apis]` part (`node_apis_logs`; with
    `node_apis_only` the phase ends there), the HTTP p50 of each kind and
    the `[aggs]` line. No hand kernel runs here (the aggregations are
    torch ops); returns no launches."""
    from elasticsearch_tpu_torch.server import build_server
    t0 = time.perf_counter()
    paths = logs_paths()
    cols = logs_columns(seed, n)
    sources = logs_sources(cols, 0, n, paths)
    log("serve_logs", data_s=f"{time.perf_counter() - t0:.2f}", docs=n,
        days=LOGS_DAYS, first=_iso(cols["ts"][0]), last=_iso(cols["ts"][-1]))
    node, server = build_server(device=device, port=0,
                                settings=SERVE_SETTINGS)
    server.start()
    try:
        client = Client(server.port)
        client.ok("PUT", "/logs", {"settings": {"number_of_shards": 1},
                                   "mappings": LOGS_MAPPING})
        first = min(N_LOGS_BULK, n)
        ops = []
        for i in range(first):
            ops += [{"index": {"_id": str(i)}}, sources[i]]
        if client.ok("POST", "/logs/_bulk", ops, ndjson=True)["errors"]:
            raise AssertionError("serve_logs: bulk errors")
        svc = node.index("logs")
        t0 = time.perf_counter()
        if n > first:
            svc.index_many([str(i) for i in range(first, n)],
                           sources[first:])
        parse_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        client.ok("POST", "/logs/_refresh")
        refresh_s = time.perf_counter() - t1
        del sources
        mapping = client.ok("GET", "/logs/_mapping")["logs"]["mappings"]
        if mapping["properties"]["request"]["fields"] != {
                "raw": {"type": "keyword", "ignore_above": 256}} \
                or svc.mapper_service.dynamic:
            raise AssertionError(f"serve_logs: mapping {mapping}")
        log("serve_logs", ingest_s=f"{parse_s + refresh_s:.2f}",
            index_many_s=f"{parse_s:.2f}",
            parse_rate_docs_s=f"{(n - first) / max(parse_s, 1e-9):.0f}",
            refresh_s=f"{refresh_s:.2f}",
            host_peak_rss_gb=f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9:.2f}")
        node_apis_logs(client, node)
        if node_apis_only:
            drop_index(client, "logs")
            return {}
        lat = {k: [] for k in LOGS_KINDS}
        pages = 0
        for kind, body, want in logs_requests(cols, paths, seed, n_each):
            t = time.perf_counter()
            resp = client.ok("POST", "/logs/_search", body)
            lat[kind].append((time.perf_counter() - t) * 1e3)
            check_logs_response(kind, resp, want)
            pages += kind.startswith("sort")
        log("serve_logs", requests=sum(map(len, lat.values())),
            sort_pages=pages, **{f"{k}_p50_ms": f"{statistics.median(v):.3f}"
                                 for k, v in lat.items()})
        parts = logs_can_match(client, node, cols, paths, n_each)
        t = time.perf_counter()
        logs_aggs(client, node, cols, parts)
        log("timing", step="serve_logs_aggs",
            seconds=f"{time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        logs_aggs_kinds(client, node, cols, parts, paths)
        log("timing", step="serve_logs_aggs_kinds",
            seconds=f"{time.perf_counter() - t:.1f}")
        telemetry_logs(client, node)
        dsl_logs(client, cols, paths)
        t = time.perf_counter()
        search_api_logs(client, cols)
        log("timing", step="search_api_logs",
            seconds=f"{time.perf_counter() - t:.1f}")
        for name in ["logs", *parts]:
            drop_index(client, name)
        logs_dynamic(client, seed, n_dynamic)
    finally:
        server.stop()
    return {}


# ------------------------------------------------------------------ telemetry
#
# The telemetry part rides the serve phases' indices: profiled requests
# against their unprofiled twins on sift_b (after `_forcemerge`), cohere
# `int8_flat`, cohere `int8_ivf`, the msmarco hybrid index and serve_logs;
# the histograms of sift's C = 8 level against its batcher's counters; a
# queued request cancelled through `_tasks`; the sampling overhead and
# `timeout` / `terminate_after` on sift_b. Every line is `[telemetry]`.

TELEMETRY_RATES = (0.0, 0.01, 1.0)     # sample rates of the overhead part
TELEMETRY_REQUESTS = 256               # sift_b's sequential requests a rate


def _trace_span_names(client, trace_id: str) -> set:
    """The span names of trace `trace_id` in the node's trace ring."""
    ring = client.ok("GET", "/_nodes/traces?size=20")
    for section in ring["nodes"].values():
        for tr in section["traces"]:
            if tr["trace_id"] == trace_id:
                return {sp["name"] for sp in tr["spans"]}
    raise AssertionError(f"trace {trace_id} is not in the trace ring")


def _hit_ids(resp) -> list:
    return [h["_id"] for h in resp["hits"]["hits"]]


def telemetry_profile(client, index: str, body: dict, program: str,
                      kernel: str, ivf: bool = False) -> dict:
    """One kNN body unprofiled, then with `profile: true`: the same hits,
    the same launches, `profile.shards[*].dispatch` naming `program` /
    `kernel` once a launch, `profile.knn` (an IVF index's engine and its
    route / score / merge nanos; an exhaustive one's block-store
    composition, as the reference reports it), and the profile's trace in
    the ring with the batch's dispatch and finalize spans. Returns the
    launches of both requests."""
    from elasticsearch_tpu_torch.ops import dispatch
    path = f"/{index}/_search"
    dispatch.reset_launches()
    plain = client.ok("POST", path, body)
    plain_launches = dispatch.launches()
    dispatch.reset_launches()
    t = time.perf_counter()
    prof = client.ok("POST", path, dict(body, profile=True))
    prof_ms = (time.perf_counter() - t) * 1e3
    launches = dispatch.launches()
    label = f"telemetry {index}"
    if launches != plain_launches or kernel not in launches:
        raise AssertionError(f"{label}: profiled launches {launches}, "
                             f"unprofiled {plain_launches}")
    if _hit_ids(prof) != _hit_ids(plain):
        raise AssertionError(f"{label}: profiled hits differ")
    shards = prof["profile"]["shards"]
    events = [e for sh in shards for e in sh.get("dispatch", [])]
    if len(events) != sum(launches.values())             or {e["kernel"] for e in events} != {program}             or {e["launch"].split("/")[0] for e in events} != {kernel}:
        raise AssertionError(f"{label}: events {events} for {launches}")
    knn = shards[0].get("knn") or {}
    if ivf:
        if knn.get("engine") != "tpu_ivf" or not all(
                knn["breakdown"].get(k, 0) > 0
                for k in ("route_nanos", "score_nanos", "merge_nanos")):
            raise AssertionError(f"{label}: profile.knn {knn}")
    elif "columnar" not in knn:
        raise AssertionError(f"{label}: profile.knn {knn}")
    names = _trace_span_names(client, prof["profile"]["trace"]["trace_id"])
    if not {"batch.dispatch", "batch.finalize", "queue.wait"} <= names:
        raise AssertionError(f"{label}: trace spans {sorted(names)}")
    query_ns = shards[0]["searches"][0]["query"][0]["time_in_nanos"]
    log("telemetry", index=index, profile="knn", hits_equal=True,
        launches=json.dumps(launches), events=len(events),
        event_kernels=json.dumps(sorted({e["launch"] for e in events})),
        engine=knn.get("engine"),
        knn_breakdown=json.dumps(knn.get("breakdown", {})),
        query_ms=f"{query_ns / 1e6:.3f}", profiled_http_ms=f"{prof_ms:.3f}",
        trace_spans=json.dumps(sorted(names)))
    return {k: launches.get(k, 0) + plain_launches.get(k, 0)
            for k in launches}


def telemetry_histograms(port: int, label: str, n: int, delta: dict) -> None:
    """`GET _nodes/stats/telemetry` after a concurrent level whose
    histograms were reset before it: `serving.queue_wait` counts one a
    request, `serving.device_dispatch` and `serving.device_sync` one a
    batch of the level's batcher (`delta`: its counters' change), and
    `search.took` one a request. Logs each one's p50 and p99."""
    client = Client(port)
    stats = client.ok("GET", "/_nodes/stats/telemetry")
    (section,) = stats["nodes"].values()
    hist = section["telemetry"]["histograms"]
    want = {"serving.queue_wait": delta["requests"],
            "serving.device_dispatch": delta["batches"],
            "serving.device_sync": delta["batches"], "search.took": n}
    got = {name: hist.get(name, {}).get("count") for name in want}
    if got != want or delta["requests"] != n:
        raise AssertionError(f"telemetry {label}: histogram counts {got}, "
                             f"expected {want}")
    fields = {}
    for name in want:
        short = name.split(".")[-1]
        fields[f"{short}_p50_ms"] = f"{hist[name]['p50_nanos'] / 1e6:.4f}"
        fields[f"{short}_p99_ms"] = f"{hist[name]['p99_nanos'] / 1e6:.4f}"
    log("telemetry", level=label, histograms=json.dumps(got), **fields,
        inflight_gauge=section["telemetry"]["gauges"].get(
            "serving.inflight_dispatches"))
    client.conn.close()


def telemetry_cancel(client, node, index: str, qv: np.ndarray) -> None:
    """A request queued behind the index batcher's run lock (held here),
    under its REST task, cancelled through `POST _tasks/{id}/_cancel`:
    once the lock is released the batcher sheds it before any launch
    (`cancelled_sheds` + 1, no launch) and the client gets the reference's
    400 `task_cancelled_exception`."""
    from elasticsearch_tpu_torch.ops import dispatch
    batcher = node.index(index).vector_store._batcher
    sheds0 = batcher.sched["cancelled_sheds"]
    out = {}

    def run():
        c = Client(client.port)
        out["resp"] = c.req("POST", f"/{index}/_search", knn_body("vec", qv),
                            headers={"X-Opaque-ID": "chip-smoke-cancel"})
        c.conn.close()

    batcher._run_lock.acquire()
    t = threading.Thread(target=run)
    try:
        t.start()
        deadline = time.monotonic() + 60
        while batcher.pending() != 1:
            if time.monotonic() > deadline:
                raise AssertionError("telemetry cancel: the request never "
                                     "queued")
            time.sleep(0.001)
        listed = client.ok("GET", "/_tasks?actions=*search")
        (task,) = [x for sec in listed["nodes"].values()
                   for x in sec["tasks"].values()
                   if x["headers"] == {"X-Opaque-Id": "chip-smoke-cancel"}]
        dispatch.reset_launches()
        resp = client.ok("POST", f"/_tasks/{task['node']}:{task['id']}"
                                 f"/_cancel")
        if not all(x["cancelled"] for sec in resp["nodes"].values()
                   for x in sec["tasks"].values()):
            raise AssertionError(f"telemetry cancel: {resp}")
    finally:
        batcher._run_lock.release()
    t.join(60)
    status, err = out["resp"]
    launches = {k: c for k, c in dispatch.launches().items() if c}
    sheds = batcher.sched["cancelled_sheds"] - sheds0
    if status != 400 or err["error"]["type"] != "task_cancelled_exception" \
            or err["error"]["reason"] != ("task cancelled while queued (shed "
                                          "at EDF admission)") \
            or sheds != 1 or launches:
        raise AssertionError(f"telemetry cancel: {status} {err}, sheds "
                             f"{sheds}, launches {launches}")
    log("telemetry", index=index, cancel="queued", status=status,
        error=err["error"]["type"], cancelled_sheds=sheds,
        launches=json.dumps(launches))


def telemetry_sift_b(client, node, rng) -> int:
    """sift_b after `_forcemerge`: the profiled-body checks
    (`telemetry_profile`), `timeout: 1ms` and `terminate_after: 1` (200,
    `timed_out` false, the same hits), and the sequential HTTP p50 of
    TELEMETRY_REQUESTS requests at each TELEMETRY_RATES sample rate, in
    one run: two blocks of half the requests a rate, in the order of the
    rates and then reversed, so a drift over the part weighs on every
    rate alike. Returns the bf16 binned kernel's launches."""
    from elasticsearch_tpu_torch import telemetry
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    qs = rng.standard_normal((TELEMETRY_REQUESTS, 128)).astype(np.float32)
    launches = sum(telemetry_profile(client, "sift_b",
                                     knn_body("vec", qs[0]), "knn.binned",
                                     kb.KERNEL_BF16).values())
    dispatch.reset_launches()
    plain = client.ok("POST", "/sift_b/_search", knn_body("vec", qs[1]))
    for extra in ({"timeout": "1ms"}, {"terminate_after": 1}):
        got = client.ok("POST", "/sift_b/_search",
                        dict(knn_body("vec", qs[1]), **extra))
        if got["timed_out"] is not False or _hit_ids(got) != _hit_ids(plain):
            raise AssertionError(f"telemetry sift_b {extra}: {got}")
    launches += dispatch.launches().get(kb.KERNEL_BF16, 0)
    rate0 = telemetry.TRACER.sample_rate
    bodies = [knn_body("vec", q) for q in qs]
    half = len(bodies) // 2
    lat = {r: [] for r in TELEMETRY_RATES}
    hits = {r: [] for r in TELEMETRY_RATES}
    traced = dict.fromkeys(TELEMETRY_RATES, 0)
    dispatch.reset_launches()
    try:
        for block, rates in enumerate((TELEMETRY_RATES,
                                       TELEMETRY_RATES[::-1])):
            for rate in rates:
                telemetry.TRACER.configure(sample_rate=rate)
                started0 = telemetry.TRACER.snapshot()["started"]
                for body in bodies[block * half:(block + 1) * half]:
                    t = time.perf_counter()
                    resp = client.ok("POST", "/sift_b/_search", body)
                    lat[rate].append((time.perf_counter() - t) * 1e3)
                    hits[rate].append(_hit_ids(resp))
                traced[rate] += (telemetry.TRACER.snapshot()["started"]
                                 - started0)
    finally:
        telemetry.TRACER.configure(sample_rate=rate0)
    for rate in TELEMETRY_RATES:
        # head sampling keeps every round(1 / rate)-th request
        every = round(1 / rate) if rate else 0
        lo = len(bodies) // every - 2 if every else 0
        hi = -(-len(bodies) // every) + 2 if every else 0
        if not lo <= traced[rate] <= hi:
            raise AssertionError(f"telemetry overhead: {traced[rate]} "
                                 f"traces at sample rate {rate}")
    if any(hits[r] != hits[0.0] for r in TELEMETRY_RATES):
        raise AssertionError("telemetry overhead: hits differ by rate")
    p50 = {r: statistics.median(v) for r, v in lat.items()}
    overhead = dispatch.launches().get(kb.KERNEL_BF16, 0)
    if overhead != len(TELEMETRY_RATES) * len(bodies):
        raise AssertionError(f"telemetry overhead: {overhead} launches")
    log("telemetry", index="sift_b", overhead_requests=len(bodies),
        **{f"p50_ms_rate_{r}": f"{p50[r]:.4f}" for r in TELEMETRY_RATES},
        traced=json.dumps({str(r): traced[r] for r in TELEMETRY_RATES}),
        timeout_and_terminate_after="same_hits")
    return launches + overhead


def telemetry_hybrid(client, node, name: str, body: dict) -> dict:
    """The msmarco hybrid body with `profile: true` against its unprofiled
    twin: the same hits and launches, `profile.hybrid` with both legs, the
    launch events naming `bm25.topk` and `knn.binned`, the queue-wait /
    launch / device-wait split of its score time, and no hit on the
    device rung of the request cache. Returns the launches."""
    from elasticsearch_tpu_torch.ops import dispatch
    path = f"/{name}/_search"
    hits0 = node.caches.device_request.hits
    dispatch.reset_launches()
    plain = client.ok("POST", path, body)
    plain_launches = dispatch.launches()
    dispatch.reset_launches()
    prof = client.ok("POST", path, dict(body, profile=True))
    launches = dispatch.launches()
    hy = prof["profile"]["hybrid"]
    events = hy.get("dispatch", [])
    bd = hy["breakdown"]
    if launches != plain_launches or _hit_ids(prof) != _hit_ids(plain) \
            or {e["kernel"] for e in events} != {"bm25.topk", "knn.binned"} \
            or len(events) != sum(launches.values()) \
            or [leg["type"] for leg in hy["legs"]] != ["lexical_device",
                                                       "knn_device"] \
            or not all(k in bd for k in ("queue_wait_nanos",
                                         "device_dispatch_nanos",
                                         "device_sync_nanos")) \
            or node.caches.device_request.hits != hits0:
        raise AssertionError(f"telemetry {name}: {hy} launches {launches} "
                             f"against {plain_launches}")
    log("telemetry", index=name, profile="hybrid", hits_equal=True,
        launches=json.dumps(launches), events=len(events),
        **{k.replace("_nanos", "_ms"): f"{v / 1e6:.4f}"
           for k, v in bd.items()},
        batch_size=hy["batch_size"])
    return {k: launches.get(k, 0) + plain_launches.get(k, 0)
            for k in launches}


def telemetry_logs(client, node) -> None:
    """One `size: 0` aggregation body with `profile: true` on the logs
    index, the device rung forced: each aggregation entry reads engine
    `device` with a positive `collect`."""
    node.settings.update({"search.aggs.device_enabled": "true",
                          "search.aggs.cost_router": "false"})
    body = {"size": 0, "profile": True, "request_cache": False,
            "aggs": {"status": {"terms": {"field": "status"}},
                     "bytes": {"avg": {"field": "size"}}}}
    resp = client.ok("POST", "/logs/_search", body)
    entries = resp["profile"]["shards"][0]["aggregations"]
    if [(e["description"], e.get("engine")) for e in entries] != [
            ("status", "device"), ("bytes", "device")] \
            or not all(e["breakdown"]["collect"] > 0 for e in entries):
        raise AssertionError(f"telemetry logs: {entries}")
    log("telemetry", index="logs", profile="aggs",
        **{f"{e['description']}_collect_ms":
           f"{e['breakdown']['collect'] / 1e6:.4f}" for e in entries})


# ------------------------------------------------ documents within documents

N_QA = 100_000          # serve_nested questions (Rally `nested`: 11,203,029)
N_CHUNKS = 32_768       # chunk children, 8 a parent document
N_PERCOLATE = 10_000    # stored queries (Rally `percolator`: 2,000,000)
QA_USERS = 20_000
QA_T0, QA_T1 = 1_217_548_800_000, 1_483_142_400_000   # 2008-08-01, 2017-01-01
QA_MAPPING = {"properties": {
    "title": {"type": "text"}, "qid": {"type": "keyword"},
    "tag": {"type": "keyword"}, "user": {"type": "keyword"},
    "creationDate": {"type": "date"},
    "answers": {"type": "nested", "properties": {
        "user": {"type": "keyword"}, "date": {"type": "date"}}}}}
CHUNK_DIMS = 384        # all-MiniLM-L6-v2
CHUNK_ENTITY_TYPES = ["person", "org", "place", "product", "event", "law",
                      "work", "date"]


def qa_columns(seed: int, n: int) -> dict:
    """Questions shaped after Rally's `nested` track (StackOverflow
    questions, each with its answers as `nested` objects): 0-8 answers a
    question, answer users Zipf-popular over QA_USERS, dates in
    2008-2016 as epoch millis, a Zipf-popular tag a question."""
    rng = np.random.default_rng(seed + 40)
    n_ans = rng.integers(0, 9, n)
    a = int(n_ans.sum())
    return {"n_ans": n_ans, "start": np.concatenate(([0], np.cumsum(n_ans))),
            "owner": np.repeat(np.arange(n), n_ans),
            "a_user": (rng.zipf(1.3, a) - 1) % QA_USERS,
            "a_date": rng.integers(QA_T0, QA_T1, a),
            "q_user": rng.integers(0, QA_USERS, n),
            "q_date": rng.integers(QA_T0, QA_T1, n),
            "tag": (rng.zipf(1.5, n) - 1) % 500,
            "words": rng.integers(0, 5000, (n, 6))}


def qa_sources(cols: dict) -> list:
    st, au, ad = cols["start"].tolist(), cols["a_user"].tolist(), \
        cols["a_date"].tolist()
    out = []
    for i, (qu, qd, tag, words) in enumerate(zip(
            cols["q_user"].tolist(), cols["q_date"].tolist(),
            cols["tag"].tolist(), cols["words"].tolist())):
        out.append({"qid": str(i), "title": " ".join(f"w{w}" for w in words),
                    "tag": f"t{tag}", "user": f"user{qu}",
                    "creationDate": qd,
                    "answers": [{"user": f"user{au[j]}", "date": ad[j]}
                                for j in range(st[i], st[i + 1])]})
    return out


def _year_keys(millis: np.ndarray) -> np.ndarray:
    return millis.astype("datetime64[ms]").astype("datetime64[Y]").astype(
        "datetime64[ms]").astype(np.int64)


def nested_timed(client, path: str, bodies, check) -> tuple:
    """Each body over HTTP, its answer held by `check(i, response)`;
    (HTTP p50 ms, the first response)."""
    lat, first = [], None
    for i, body in enumerate(bodies):
        t = time.perf_counter()
        resp = client.ok("POST", path, body)
        lat.append((time.perf_counter() - t) * 1e3)
        check(i, resp)
        first = first or resp
    return statistics.median(lat), first


def nested_qa(client, node, seed: int, n: int) -> None:
    """The `qa` index: `nested` `term` on `answers.user` and `range` on
    `answers.date`, both with inner hits of size 3 and 100, and a `nested`
    aggregation holding a yearly `date_histogram` on `answers.date` with a
    `reverse_nested` inside, and one holding the `top_hits` of the newest
    three answers; every total, inner hit count, bucket and listed answer
    numpy's over the generated answers."""
    t0 = time.perf_counter()
    cols = qa_columns(seed, n)
    sources = qa_sources(cols)
    data_s = time.perf_counter() - t0
    client.ok("PUT", "/qa", {"settings": {"number_of_shards": 1},
                             "mappings": QA_MAPPING})
    first = min(2000, n)
    ops = []
    for i in range(first):
        ops += [{"index": {"_id": str(i)}}, sources[i]]
    if client.ok("POST", "/qa/_bulk", ops, ndjson=True)["errors"]:
        raise AssertionError("nested qa: bulk errors")
    t0 = time.perf_counter()
    node.index("qa").index_many([str(i) for i in range(first, n)],
                                sources[first:])
    client.ok("POST", "/qa/_refresh")
    ingest_s = time.perf_counter() - t0
    del sources, ops
    owner, a_user, a_date = cols["owner"], cols["a_user"], cols["a_date"]
    n_ans, start = cols["n_ans"], cols["start"]
    log("nested", part="qa", docs=n, answers=len(owner),
        data_s=f"{data_s:.2f}", ingest_s=f"{ingest_s:.2f}")
    rng = np.random.default_rng(seed + 41)
    users = a_user[rng.integers(0, len(a_user), 16)]
    los = rng.integers(QA_T0, QA_T1 - 30 * 86_400_000, 16)
    term_q = [{"term": {"answers.user": f"user{u}"}} for u in users]
    range_q = [{"range": {"answers.date": {
        "gte": int(lo), "lte": int(lo) + 30 * 86_400_000}}} for lo in los]
    want_term = [np.unique(owner[a_user == u]) for u in users]
    want_range = [np.unique(owner[(a_date >= lo)
                                  & (a_date <= lo + 30 * 86_400_000)])
                  for lo in los]

    def answers_of(q: int) -> slice:
        return slice(start[q], start[q + 1])

    def checker(kind, want, size=None):
        def check(i, resp):
            total = resp["hits"]["total"]["value"]
            if total != len(want[i]):
                raise AssertionError(f"nested qa {kind}: total {total}, "
                                     f"numpy {len(want[i])}")
            for h in resp["hits"]["hits"]:
                q = int(h["_id"])
                if not np.isin(q, want[i]):
                    raise AssertionError(f"nested qa {kind}: hit {q}")
                if size is None:
                    continue
                ih = h["inner_hits"]["answers"]["hits"]
                sl = answers_of(q)
                # term: the objects of that user; range: the inner hits'
                # looser matcher lists every object (kept from the
                # reference)
                listed = (np.nonzero(a_user[sl] == users[i])[0]
                          if kind == "term" else np.arange(n_ans[q]))
                if ih["total"]["value"] != len(listed) \
                        or [x["_nested"]["offset"] for x in ih["hits"]] \
                        != listed[:size].tolist():
                    raise AssertionError(f"nested qa {kind} inner hits of "
                                         f"{q}: {ih}")
        return check

    lines = {}
    for kind, qs, want in (("term", term_q, want_term),
                           ("range", range_q, want_range)):
        for size in (None, 3, 100):
            bodies = []
            for q in qs:
                nested = {"path": "answers", "query": q}
                if size is not None:
                    nested["inner_hits"] = {} if size == 3 \
                        else {"size": size}
                bodies.append({"query": {"nested": nested},
                               "track_total_hits": True})
            label = kind if size is None else f"{kind}_inner_hits_{size}"
            p50, resp = nested_timed(client, "/qa/_search", bodies,
                                     checker(kind, want, size))
            lines[f"{label}_p50_ms"] = f"{p50:.3f}"
            lines[f"{label}_total0"] = resp["hits"]["total"]["value"]
    tags = np.unique(cols["tag"], return_counts=True)
    tags = tags[0][np.argsort(-tags[1], kind="stable")][:16]

    def check_agg(i, resp):
        rows = np.nonzero(cols["tag"] == tags[i])[0]
        agg = resp["aggregations"]["answers"]
        if agg["doc_count"] != int(n_ans[rows].sum()):
            raise AssertionError(f"nested qa agg doc_count {agg}")
        with_ans = rows[n_ans[rows] > 0]
        # the histogram reads each question's first answer date, as a
        # multi-valued doc's first value
        keys, counts = np.unique(_year_keys(a_date[start[with_ans]]),
                                 return_counts=True)
        want = dict(zip(keys.tolist(), counts.tolist()))
        got = {b["key"]: b["doc_count"] for b in agg["years"]["buckets"]}
        if {k: c for k, c in got.items() if c} != want or any(
                b["questions"]["doc_count"] != b["doc_count"]
                for b in agg["years"]["buckets"]):
            raise AssertionError(f"nested qa agg buckets {got} != {want}")

    bodies = [{"size": 0, "query": {"term": {"tag": f"t{t}"}}, "aggs": {
        "answers": {"nested": {"path": "answers"}, "aggs": {
            "years": {"date_histogram": {"field": "answers.date",
                                         "calendar_interval": "year"},
                      "aggs": {"questions": {"reverse_nested": {}}}}}}}}
              for t in tags]
    p50, resp = nested_timed(client, "/qa/_search", bodies, check_agg)
    lines["agg_p50_ms"] = f"{p50:.3f}"
    lines["agg_doc_count0"] = resp["aggregations"]["answers"]["doc_count"]

    def check_top_hits(i, resp):
        # the newest three answers of the tag's questions: date desc, ties
        # in question and answer order
        rows = np.nonzero(cols["tag"] == tags[i])[0]
        ans = np.concatenate([np.arange(start[q], start[q + 1])
                              for q in rows]) if len(rows) else rows
        order = ans[np.lexsort((ans, -a_date[ans]))][:3]
        want = [(str(owner[j]), int(j - start[owner[j]]),
                 {"user": f"user{a_user[j]}", "date": int(a_date[j])},
                 [int(a_date[j])]) for j in order]
        hits = resp["aggregations"]["answers"]["newest"]["hits"]
        got = [(h["_id"], h["_nested"]["offset"], h["_source"], h["sort"])
               for h in hits["hits"]]
        if got != want or hits["total"]["value"] != len(ans):
            raise AssertionError(f"nested qa top_hits {got} != {want}")

    bodies = [{"size": 0, "query": {"term": {"tag": f"t{t}"}}, "aggs": {
        "answers": {"nested": {"path": "answers"}, "aggs": {
            "newest": {"top_hits": {"size": 3,
                                    "sort": [{"answers.date": "desc"}]}}}}}}
              for t in tags]
    p50, resp = nested_timed(client, "/qa/_search", bodies, check_top_hits)
    lines["top_hits_p50_ms"] = f"{p50:.3f}"
    log("nested", part="qa", **lines)
    drop_index(client, "qa")


def chunk_columns(seed: int, n: int) -> dict:
    """Parent documents of 8 chunk children each; a chunk's 384-d vector,
    its 1-3 `entities` ({type, name}: Zipf-popular over 1,000 names)."""
    rng = np.random.default_rng(seed + 42)
    n_ent = rng.integers(1, 4, n)
    return {"vecs": clustered32(rng, n, CHUNK_DIMS), "n_ent": n_ent,
            "ent_start": np.concatenate(([0], np.cumsum(n_ent))),
            "ent_name": (rng.zipf(1.3, int(n_ent.sum())) - 1) % 1000,
            "ent_type": rng.integers(0, len(CHUNK_ENTITY_TYPES),
                                     int(n_ent.sum()))}


def nested_chunks(client, node, seed: int, n: int) -> int:
    """The `chunks` index (two shards): parents with chunk children routed
    by their parent's id, a `join` between them. `knn` filtered by
    `has_parent` on the parent's category and by `nested` on an entity
    name (the exact route with a mask): recall@10 >= 0.95 against numpy's
    exact top 10 over the filter's rows, whose count is numpy's;
    `has_child` around a `knn` clause (the binned kernel): the parents of
    the same `knn` body's own hits; `parent_id`: numpy's total. Returns
    the binned launches."""
    from elasticsearch_tpu_torch.ops import dispatch
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    t0 = time.perf_counter()
    cols = chunk_columns(seed, n)
    vecs = cols["vecs"]
    n_par = n // 8
    parent = np.arange(n) // 8
    es, en, et = cols["ent_start"], cols["ent_name"].tolist(), \
        cols["ent_type"].tolist()
    p_src = [{"rel": "doc", "category": f"c{p % 16}",
              "title": f"document {p}"} for p in range(n_par)]
    c_src = [{"rel": {"name": "chunk", "parent": f"p{parent[c]}"},
              "entities": [{"type": CHUNK_ENTITY_TYPES[et[j]],
                            "name": f"e{en[j]}"}
                           for j in range(es[c], es[c + 1])]}
             for c in range(n)]
    c_ids = [f"p{parent[c]}c{c % 8}" for c in range(n)]
    data_s = time.perf_counter() - t0
    client.ok("PUT", "/chunks", {
        "settings": {"number_of_shards": 2},
        "mappings": {"properties": {
            "rel": {"type": "join", "relations": {"doc": "chunk"}},
            "category": {"type": "keyword"}, "title": {"type": "text"},
            "emb": {"type": "dense_vector", "dims": CHUNK_DIMS,
                    "similarity": "cosine"},
            "entities": {"type": "nested", "properties": {
                "type": {"type": "keyword"},
                "name": {"type": "keyword"}}}}}})
    t0 = time.perf_counter()
    first = min(64, n_par)          # over `_bulk`, children routed
    ops = []
    for p in range(first):
        ops += [{"index": {"_id": f"p{p}"}}, p_src[p]]
        for c in range(8 * p, 8 * p + 8):
            ops += [{"index": {"_id": c_ids[c], "routing": f"p{p}"}},
                    dict(c_src[c], emb=vecs[c].tolist())]
    if client.ok("POST", "/chunks/_bulk", ops, ndjson=True)["errors"]:
        raise AssertionError("nested chunks: bulk errors")
    svc = node.index("chunks")
    svc.index_many([f"p{p}" for p in range(first, n_par)], p_src[first:])
    lo = 8 * first
    svc.index_many(c_ids[lo:], c_src[lo:], vectors={"emb": vecs[lo:]},
                   routings=[f"p{parent[c]}" for c in range(lo, n)])
    client.ok("POST", "/chunks/_refresh")
    ingest_s = time.perf_counter() - t0
    log("nested", part="chunks", parents=n_par, chunks=n,
        dims=CHUNK_DIMS, shards=2, data_s=f"{data_s:.2f}",
        ingest_s=f"{ingest_s:.2f}")
    rng = np.random.default_rng(seed + 43)
    queries = vecs[rng.integers(0, n, 16)] + 0.3 * rng.standard_normal(
        (16, CHUNK_DIMS), dtype=np.float32)
    chunk_of = {cid: c for c, cid in enumerate(c_ids)}
    names, counts = np.unique(cols["ent_name"], return_counts=True)
    popular = names[counts >= 40]
    pick = popular[rng.integers(0, len(popular), 16)]
    has_name = [np.unique(np.repeat(np.arange(n), cols["n_ent"])[
        cols["ent_name"] == e]) for e in pick]
    lines = {}
    for kind, filters, rows in (
            ("has_parent", [{"has_parent": {"parent_type": "doc", "query": {
                "term": {"category": f"c{i}"}}}} for i in range(16)],
             [np.nonzero(parent % 16 == i)[0] for i in range(16)]),
            ("nested", [{"nested": {"path": "entities", "query": {
                "term": {"entities.name": f"e{e}"}}}} for e in pick],
             has_name)):
        recalls = []

        def check(i, resp):
            got = [chunk_of[h["_id"]] for h in resp["hits"]["hits"]]
            want = rows[i][exact_top(vecs[rows[i]], queries[i:i + 1], 10,
                                     "cosine")[0]]
            if not set(got) <= set(rows[i].tolist()):
                raise AssertionError(f"nested chunks {kind}: a hit outside "
                                     f"the filter")
            recalls.append(len(set(got) & set(want.tolist())) / 10)

        bodies = [{"knn": {"field": "emb", "query_vector": q.tolist(),
                           "k": 10, "num_candidates": 100, "filter": f},
                   "_source": False}
                  for q, f in zip(queries, filters)]
        dispatch.reset_launches()
        p50, _ = nested_timed(client, "/chunks/_search", bodies, check)
        if dispatch.launches().get(kb.KERNEL_BF16, 0):
            raise AssertionError(f"nested chunks {kind}: a filtered knn "
                                 f"launched the binned kernel")
        recall = float(np.mean(recalls))
        if recall < 0.95:
            raise AssertionError(f"nested chunks {kind} recall@10 {recall}")

        def check_count(i, resp):
            if resp["hits"]["total"]["value"] != len(rows[i]):
                raise AssertionError(f"nested chunks {kind} filter rows "
                                     f"{resp['hits']['total']}, numpy "
                                     f"{len(rows[i])}")

        count_p50, _ = nested_timed(client, "/chunks/_search", [
            {"query": f, "size": 0, "track_total_hits": True}
            for f in filters], check_count)
        lines.update({f"knn_{kind}_p50_ms": f"{p50:.3f}",
                      f"knn_{kind}_recall_at_10": recall,
                      f"{kind}_count_p50_ms": f"{count_p50:.3f}",
                      f"{kind}_rows0": len(rows[0])})
    launches = 0
    plain = []
    for q in queries:
        knn = {"knn": {"field": "emb", "query_vector": q.tolist(), "k": 10,
                       "num_candidates": 100}}
        resp = client.ok("POST", "/chunks/_search", {
            "query": knn, "size": 1000, "_source": False})
        if resp["hits"]["total"]["value"] > 1000:
            raise AssertionError("nested chunks: knn leg over 1000 hits")
        plain.append({f"p{parent[chunk_of[h['_id']]]}"
                      for h in resp["hits"]["hits"]})

    def check_child(i, resp):
        nonlocal launches
        got = dispatch.launches().get(kb.KERNEL_BF16, 0)
        if got < 1:
            raise AssertionError("nested chunks has_child: no binned launch")
        launches += got
        dispatch.reset_launches()
        if {h["_id"] for h in resp["hits"]["hits"]} != plain[i]:
            raise AssertionError("nested chunks has_child: parents differ "
                                 "from the knn body's own hits")

    bodies = [{"query": {"has_child": {"type": "chunk", "query": {"knn": {
        "field": "emb", "query_vector": q.tolist(), "k": 10,
        "num_candidates": 100}}}}, "size": 100, "_source": False}
        for q in queries]
    dispatch.reset_launches()
    p50, _ = nested_timed(client, "/chunks/_search", bodies, check_child)
    lines["has_child_knn_p50_ms"] = f"{p50:.3f}"
    lines["has_child_launches"] = launches
    parents = rng.integers(0, n_par, 16)

    def check_parent_id(i, resp):
        if resp["hits"]["total"]["value"] != int(
                np.count_nonzero(parent == parents[i])):
            raise AssertionError(f"nested chunks parent_id {resp['hits']}")

    p50, _ = nested_timed(client, "/chunks/_search", [
        {"query": {"parent_id": {"type": "chunk", "id": f"p{p}"}},
         "track_total_hits": True} for p in parents], check_parent_id)
    lines["parent_id_p50_ms"] = f"{p50:.3f}"
    log("nested", part="chunks", **lines)
    drop_index(client, "chunks")
    return launches


def nested_percolator(client, node, seed: int, n: int) -> None:
    """The `perc` index: `n` stored queries shaped after Rally's
    `percolator` track (`match` on a text field, `bool` of a `term` and a
    `range`), 16 documents percolated; each hit set the check's own
    evaluation of the generated shapes."""
    rng = np.random.default_rng(seed + 44)
    words = rng.integers(0, 2000, (n, 2))
    q_tag = rng.integers(0, 50, n)
    q_lo = rng.integers(0, 900, n)
    q_width = rng.integers(10, 200, n)
    stored = [{"match": {"body": f"w{words[i, 0]} w{words[i, 1]}"}}
              if i % 2 == 0 else
              {"bool": {"must": [{"term": {"tag": f"t{q_tag[i]}"}}],
                        "filter": [{"range": {"price": {
                            "gte": int(q_lo[i]),
                            "lte": int(q_lo[i] + q_width[i])}}}]}}
              for i in range(n)]
    client.ok("PUT", "/perc", {"settings": {"number_of_shards": 1},
                               "mappings": {"properties": {
                                   "query": {"type": "percolator"},
                                   "body": {"type": "text"},
                                   "tag": {"type": "keyword"},
                                   "price": {"type": "long"}}}})
    t0 = time.perf_counter()
    node.index("perc").index_many([str(i) for i in range(n)],
                                  [{"query": q} for q in stored])
    client.ok("POST", "/perc/_refresh")
    ingest_s = time.perf_counter() - t0
    docs = []
    for _ in range(16):
        docs.append({"body": " ".join(f"w{w}" for w in
                                      rng.integers(0, 2000, 40)),
                     "tag": f"t{int(rng.integers(0, 50))}",
                     "price": int(rng.integers(0, 1000))})
    even = np.arange(n) % 2 == 0

    def check(i, resp):
        doc = docs[i]
        have = np.zeros(2000, dtype=bool)
        have[[int(w[1:]) for w in doc["body"].split()]] = True
        want = (even & (have[words[:, 0]] | have[words[:, 1]])) | (
            ~even & (q_tag == int(doc["tag"][1:]))
            & (q_lo <= doc["price"]) & (doc["price"] <= q_lo + q_width))
        got = {int(h["_id"]) for h in resp["hits"]["hits"]}
        if got != set(np.nonzero(want)[0].tolist()) \
                or resp["hits"]["total"]["value"] != len(got):
            raise AssertionError(f"nested percolate doc {i}: "
                                 f"{len(got)} hits, want {int(want.sum())}")

    p50, resp = nested_timed(client, "/perc/_search", [
        {"query": {"percolate": {"field": "query", "document": d}},
         "size": 10_000, "_source": False, "track_total_hits": True}
        for d in docs], check)
    log("nested", part="percolator", stored=n, ingest_s=f"{ingest_s:.2f}",
        percolate_p50_ms=f"{p50:.3f}",
        hits0=resp["hits"]["total"]["value"])
    drop_index(client, "perc")


def phase_serve_nested(seed: int, n_qa: int = N_QA, n_chunks: int = N_CHUNKS,
                       n_percolate: int = N_PERCOLATE,
                       device: str = "cuda") -> dict:
    """serve_nested: documents within documents (the `[nested]` lines).
    `qa` (`nested_qa`, Rally's `nested` track cut from 11,203,029 to
    `n_qa` questions), `chunks` (`nested_chunks`: parent documents with
    chunk children that carry the vectors, as RAG deployments index them)
    and the percolator (`nested_percolator`, Rally's `percolator` track
    cut to `n_percolate` stored queries). Returns the binned launches."""
    from elasticsearch_tpu_torch.ops import knn_binned as kb
    from elasticsearch_tpu_torch.server import build_server
    node, server = build_server(device=device, port=0,
                                settings=SERVE_SETTINGS)
    server.start()
    try:
        client = Client(server.port)
        t = time.perf_counter()
        nested_qa(client, node, seed, n_qa)
        log("timing", step="nested_qa",
            seconds=f"{time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        launches = nested_chunks(client, node, seed, n_chunks)
        log("timing", step="nested_chunks",
            seconds=f"{time.perf_counter() - t:.1f}")
        t = time.perf_counter()
        nested_percolator(client, node, seed, n_percolate)
        log("timing", step="nested_percolator",
            seconds=f"{time.perf_counter() - t:.1f}")
    finally:
        server.stop()
    return {kb.KERNEL_BF16: launches}


def timed(label: str, phase, *args, **kwargs):
    """Run one phase and log its wall seconds."""
    t = time.perf_counter()
    out = phase(*args, **kwargs)
    log("timing", step=label, seconds=f"{time.perf_counter() - t:.1f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--n-sift", type=int, default=1_000_000)
    ap.add_argument("--n-cohere", type=int, default=1_000_000)
    # 500,000 (1,000,000 until the `[nested]` part needed its time)
    ap.add_argument("--n-gist", type=int, default=500_000)
    ap.add_argument("--n-cohere-ivf", type=int, default=1_000_000)
    ap.add_argument("--n-colbert", type=int, default=131_071)
    ap.add_argument("--n-laion", type=int, default=1_000_000)
    ap.add_argument("--n-sharded", type=int, default=N_SHARDED)
    ap.add_argument("--binned-only", action="store_true",
                    help="build and measure only the binned kernels (no "
                         "serving phases, no final ok line): the numbers "
                         "of PERF.md's parent-vs-change comparisons")
    ap.add_argument("--ivf-only", action="store_true",
                    help="build and measure only the fused IVF kernels, "
                         "likewise")
    ap.add_argument("--maxsim-only", action="store_true",
                    help="build and measure only the MaxSim kernels, "
                         "likewise")
    ap.add_argument("--sharded-only", action="store_true",
                    help="build and run only serve_sharded (no final ok "
                         "line): its ingest, memory and latency at "
                         "--n-sharded rows")
    ap.add_argument("--n-msmarco", type=int, default=N_MSMARCO)
    ap.add_argument("--hybrid-only", action="store_true",
                    help="build, check bm25_board and run only "
                         "serve_hybrid at --n-msmarco passages (no final "
                         "ok line)")
    ap.add_argument("--docs-only", action="store_true",
                    help="build the binned kernels and run only serve_sift's "
                         "sequential requests and serve_documents at "
                         "--n-sift docs (no final ok line)")
    ap.add_argument("--segments-only", action="store_true",
                    help="build the binned and IVF kernels and run only "
                         "serve_sift's sequential requests, "
                         "serve_documents (with sift_b's generations) at "
                         "--n-sift docs and serve_ivf_compaction (no "
                         "final ok line)")
    ap.add_argument("--body-only", action="store_true",
                    help="build the binned kernels and run only the laion "
                         "index of serve_filtered at --n-laion rows with "
                         "its unfiltered requests and the search body's "
                         "part (no final ok line)")
    ap.add_argument("--dsl-only", action="store_true",
                    help="build the binned and BM25 kernels and run only "
                         "the phases that carry the [dsl] part "
                         "(serve_hybrid at --n-msmarco, the laion index "
                         "at --n-laion with its unfiltered requests, "
                         "serve_sift's sequential requests and "
                         "serve_documents at --n-sift; no final ok line)")
    ap.add_argument("--search-api-only", action="store_true",
                    help="build the binned and BM25 kernels and run only "
                         "the phases that carry the [search_api] part "
                         "(serve_hybrid at --n-msmarco, the laion index "
                         "at --n-laion and the part alone, serve_sift's "
                         "sequential requests and serve_documents at "
                         "--n-sift, serve_logs at --n-logs; no final ok "
                         "line)")
    ap.add_argument("--n-sparse", type=int, default=N_SPARSE)
    ap.add_argument("--sparse-only", action="store_true",
                    help="build, check bm25_board (the BM25 and the "
                         "learned-sparse cases) and run only serve_sparse "
                         "at --n-sparse passages (no final ok line)")
    ap.add_argument("--n-logs", type=int, default=N_LOGS)
    ap.add_argument("--logs-only", action="store_true",
                    help="run only serve_logs at --n-logs lines (no "
                         "kernel build, no final ok line)")
    ap.add_argument("--n-qa", type=int, default=N_QA)
    ap.add_argument("--nested-only", action="store_true",
                    help="build the binned kernels and run only "
                         "serve_nested (the qa index at --n-qa questions, "
                         "the chunks index, the percolator; no final ok "
                         "line)")
    ap.add_argument("--node-apis-only", action="store_true",
                    help="build the binned kernels and run only the "
                         "phases that carry the [node_apis] part "
                         "(serve_sift's sequential requests and "
                         "serve_documents at --n-sift, then the logs "
                         "index at --n-logs with the part's host APIs; "
                         "no final ok line)")
    ap.add_argument("--telemetry-only", action="store_true",
                    help="build the binned, IVF and BM25 kernels and run "
                         "only the phases that carry the telemetry part "
                         "(serve_sift with serve_documents and "
                         "serve_cohere, serve_ivf, serve_hybrid, "
                         "serve_logs) at the sizes given (no final ok "
                         "line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import elasticsearch_tpu_torch  # noqa: F401  (fails outside the repo)

    smi = phase_env()
    for only, name, phase in ((args.binned_only, "knn_binned",
                               phase_binned_kernels),
                              (args.ivf_only, "ivf_fused",
                               phase_ivf_kernels),
                              (args.maxsim_only, "maxsim",
                               phase_maxsim_kernels)):
        if only:
            phase_build([name])
            kernels = phase(args.seed, torch.device("cuda"))
            print(json.dumps({"kernels": list(kernels.values())}))
            print(smi)
            return 0
    if args.logs_only:
        timed("serve_logs", phase_serve_logs, args.seed, args.n_logs)
        return 0
    if args.nested_only:
        phase_build(["knn_binned"])
        timed("serve_nested", phase_serve_nested, args.seed, args.n_qa)
        return 0
    if args.node_apis_only:
        phase_build(["knn_binned"])
        timed("serve_documents", phase_serve, args.seed, args.n_sift, 0,
              docs_only=True)
        timed("node_apis_logs", phase_serve_logs, args.seed, args.n_logs,
              node_apis_only=True)
        return 0
    if args.telemetry_only:
        phase_build(["knn_binned", "ivf_fused", "bm25"])
        timed("serve_sift_cohere", phase_serve, args.seed, args.n_sift,
              args.n_cohere)
        timed("serve_ivf", phase_serve_ivf, args.seed, args.n_gist,
              args.n_cohere_ivf)
        timed("serve_hybrid", phase_serve_hybrid, args.seed,
              args.n_msmarco)
        timed("serve_logs", phase_serve_logs, args.seed, args.n_logs)
        return 0
    if args.docs_only:
        phase_build(["knn_binned"])
        phase_serve(args.seed, args.n_sift, 0, docs_only=True)
        return 0
    if args.segments_only:
        phase_build(["knn_binned", "ivf_fused"])
        timed("serve_documents", phase_serve, args.seed, args.n_sift, 0,
              docs_only=True)
        timed("serve_ivf_compaction", phase_serve_ivf, args.seed, 0,
              args.n_cohere_ivf, compaction_only=True)
        return 0
    if args.dsl_only:
        phase_build(["knn_binned", "bm25"])
        timed("serve_hybrid", phase_serve_hybrid, args.seed,
              args.n_msmarco)
        timed("dsl_laion", phase_serve_filtered, args.seed, args.n_laion,
              dsl_only=True)
        timed("serve_documents", phase_serve, args.seed, args.n_sift, 0,
              docs_only=True)
        return 0
    if args.search_api_only:
        phase_build(["knn_binned", "bm25"])
        timed("serve_hybrid", phase_serve_hybrid, args.seed,
              args.n_msmarco)
        timed("search_api_laion", phase_serve_filtered, args.seed,
              args.n_laion, search_api_only=True)
        timed("serve_documents", phase_serve, args.seed, args.n_sift, 0,
              docs_only=True)
        timed("serve_logs", phase_serve_logs, args.seed, args.n_logs)
        return 0
    if args.body_only:
        phase_build(["knn_binned"])
        timed("serve_body", phase_serve_filtered, args.seed, args.n_laion,
              body_only=True)
        return 0
    phase_build()
    if args.sharded_only:
        phase_serve_sharded(args.seed, args.n_sharded, smi=smi)
        return 0
    for only, phase, n in ((args.hybrid_only, phase_serve_hybrid,
                            args.n_msmarco),
                           (args.sparse_only, phase_serve_sparse,
                            args.n_sparse)):
        if only:
            kernels = phase_bm25_kernel(args.seed, torch.device("cuda"),
                                        args.n_msmarco, args.n_sparse)
            launches = phase(args.seed, n)
            for name, entry in kernels.items():
                entry["launches"] = launches[name]
            print(json.dumps({"kernels": list(kernels.values())}))
            print(smi)
            return 0
    cuda = torch.device("cuda")
    kernels = timed("kernels_binned", phase_binned_kernels, args.seed, cuda)
    kernels.update(timed("kernels_ivf", phase_ivf_kernels, args.seed, cuda))
    kernels.update(timed("kernels_maxsim", phase_maxsim_kernels, args.seed,
                         cuda))
    kernels.update(timed("kernels_bm25", phase_bm25_kernel, args.seed, cuda,
                         args.n_msmarco, args.n_sparse))
    launches = timed("serve_sift_cohere", phase_serve, args.seed,
                     args.n_sift, args.n_cohere)
    one_shard = {}
    launches.update(timed("serve_ivf", phase_serve_ivf, args.seed,
                          args.n_gist, args.n_cohere_ivf, report=one_shard))
    phases = [timed("serve_colbert", phase_serve_colbert, args.seed,
                    args.n_colbert),
              timed("serve_filtered", phase_serve_filtered, args.seed,
                    args.n_laion),
              timed("serve_sharded", phase_serve_sharded, args.seed,
                    args.n_sharded, smi=smi, one_shard=one_shard),
              timed("serve_hybrid", phase_serve_hybrid, args.seed,
                    args.n_msmarco)]
    sparse_launches = timed("serve_sparse", phase_serve_sparse, args.seed,
                            args.n_sparse)
    phases.append(timed("serve_logs", phase_serve_logs, args.seed,
                        args.n_logs))
    phases.append(timed("serve_nested", phase_serve_nested, args.seed,
                        args.n_qa))
    for phase in phases + [sparse_launches]:
        for name, count in phase.items():
            launches[name] = launches.get(name, 0) + count
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
    from elasticsearch_tpu_torch.ops import bm25
    kernels[bm25.KERNEL]["sparse_launches"] = sparse_launches[bm25.KERNEL]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
