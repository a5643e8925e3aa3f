"""Indices: the per-index service that holds an index's shards."""
