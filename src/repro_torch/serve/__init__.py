"""Serving: the admission-control layer of the query server (bounded
queues, overload policies, the result cache, fault injection)."""
from repro_torch.serve.admission import (
    AdmissionError, AdmissionQueue, FaultPlan, QueryStatus,
    QueryValidationError, ResultCache, ServeConfig,
)

__all__ = [
    "AdmissionError", "AdmissionQueue", "FaultPlan", "QueryStatus",
    "QueryValidationError", "ResultCache", "ServeConfig",
]
