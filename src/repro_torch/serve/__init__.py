"""Serving: the admission-control layer of the query server (bounded
queues, overload policies, the result cache, fault injection), plus lazy
re-exports of the LM serving glue.

The LM step factories (``cache_axes_tree`` / ``make_serve_steps``) live
with the training substrate under ``repro_torch.lm``; they are resolved
lazily here, so importing ``repro_torch.serve`` (or any of its
submodules, which runs this ``__init__``) does not load the LM stack.
"""
from repro_torch.serve.admission import (
    AdmissionError, AdmissionQueue, FaultPlan, QueryStatus,
    QueryValidationError, ResultCache, ServeConfig,
)

_LM_EXPORTS = {"cache_axes_tree", "make_serve_steps"}

__all__ = [
    "AdmissionError", "AdmissionQueue", "FaultPlan", "QueryStatus",
    "QueryValidationError", "ResultCache", "ServeConfig",
    "cache_axes_tree", "make_serve_steps",
]


def __getattr__(name):
    if name in _LM_EXPORTS:
        from repro_torch.lm.train import train_step
        return getattr(train_step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
