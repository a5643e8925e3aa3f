"""Port of the vector, token and postings blocks of
`elasticsearch_tpu/columnar`, and of its block store's vector half."""
