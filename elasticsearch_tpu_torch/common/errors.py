"""Status-carrying exceptions rendered by the REST layer.

A copy of the subset of `elasticsearch_tpu/common/errors.py` (and of
`EsRejectedExecutionError` from `elasticsearch_tpu/common/threadpool.py`)
that the port raises: the same class names, so the same snake-cased
`error.type` strings and HTTP statuses reach clients.
"""

from __future__ import annotations


class SearchEngineError(Exception):
    """Base of all framework errors. Carries an HTTP status for the REST layer."""

    status = 500

    def __init__(self, message: str = "", **metadata):
        super().__init__(message)
        self.message = message
        self.metadata = metadata

    @property
    def error_type(self) -> str:
        # IndexNotFoundError -> index_not_found_exception
        name = type(self).__name__
        if name.endswith("Error"):
            name = name[: -len("Error")]
        out = []
        for i, ch in enumerate(name):
            if ch.isupper() and i > 0:
                out.append("_")
            out.append(ch.lower())
        return "".join(out) + "_exception"

    def to_dict(self) -> dict:
        d = {"type": self.error_type, "reason": self.message}
        d.update(self.metadata)
        return d

    def to_wrapped_dict(self) -> dict:
        inner = self.to_dict()
        return {**inner, "root_cause": [dict(inner)]}


class IllegalArgumentError(SearchEngineError):
    status = 400


class ParsingError(SearchEngineError):
    status = 400


class MapperParsingError(SearchEngineError):
    status = 400


class TooManyBucketsError(SearchEngineError):
    """search.max_buckets exceeded (MultiBucketConsumerService)."""
    status = 503


class ArrayIndexOutOfBoundsError(SearchEngineError):
    """A failure inside an aggregator that fails its shard: HDR
    percentiles recording a negative value."""
    status = 500


class SearchPhaseExecutionError(SearchEngineError):
    """Every shard of a search failed ("all shards failed")."""
    status = 503

    def __init__(self, phase: str, message: str, shard_failures=()):
        super().__init__(message, phase=phase)
        self.phase = phase
        self.shard_failures = list(shard_failures)


class QueryShardError(SearchEngineError):
    """A query cannot run against this shard's mappings (e.g. `exists` on
    [_source])."""

    status = 400


class ActionRequestValidationError(SearchEngineError):
    """Aggregated request validation failures ("Validation Failed: 1:
    ...;")."""

    status = 400

    @classmethod
    def of(cls, failures) -> "ActionRequestValidationError":
        msg = "Validation Failed: " + " ".join(
            f"{i + 1}: {m};" for i, m in enumerate(failures))
        return cls(msg)


class InvalidIndexNameError(SearchEngineError):
    status = 400


class ResourceNotFoundError(SearchEngineError):
    status = 404


class DocumentMissingError(ResourceNotFoundError):
    status = 404


class IndexNotFoundError(ResourceNotFoundError):
    status = 404

    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]", index=index)
        self.index = index


class ResourceAlreadyExistsError(SearchEngineError):
    status = 400


class VersionConflictError(SearchEngineError):
    status = 409

    @property
    def error_type(self) -> str:
        # the engine-layer name the REST layer exposes
        return "version_conflict_engine_exception"


class TaskCancelledError(SearchEngineError):
    status = 400


class IndexClosedError(SearchEngineError):
    """A data operation on a closed index."""

    status = 400


class EsRejectedExecutionError(SearchEngineError):
    """Queue full, or a request shed at its deadline: the caller gets
    backpressure (HTTP 429)."""

    status = 429

    def to_dict(self):
        return {"type": "es_rejected_execution_exception",
                "reason": str(self)}
