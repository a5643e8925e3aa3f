"""Port of the token blocks of `elasticsearch_tpu/columnar`."""
