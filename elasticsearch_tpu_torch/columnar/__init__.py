"""Port of the token and postings blocks of `elasticsearch_tpu/columnar`."""
