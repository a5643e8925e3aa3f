"""Cluster-level pieces of the port (document routing)."""
