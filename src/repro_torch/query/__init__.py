"""Lane-batched multi-query execution: many source-rooted queries as the
lanes of one shared fixpoint (``lanes``), served by the
continuous-batching ``QueryServer`` (``server``) behind the admission
layer (``repro_torch.serve``)."""
from repro_torch.query.lanes import (
    LaneStats, init_lane_values, make_ppr_delta_round, make_ppr_round,
    make_sharded_lanes_fn, make_sharded_min_round, make_sharded_ppr_round,
    make_sharded_ppr_delta_round, make_stacked_lanes_fn, ppr_base_table,
    run_ppr_delta_lanes, run_ppr_lanes, run_sharded_lanes,
    run_stacked_lanes,
)
from repro_torch.query.server import QueryRequest, QueryResult, QueryServer
from repro_torch.serve.admission import (
    AdmissionError, AdmissionQueue, FaultPlan, QueryStatus,
    QueryValidationError, ResultCache, ServeConfig,
)

__all__ = [
    "AdmissionError", "AdmissionQueue", "FaultPlan", "LaneStats",
    "QueryRequest", "QueryResult", "QueryServer", "QueryStatus",
    "QueryValidationError", "ResultCache", "ServeConfig",
    "init_lane_values", "make_ppr_delta_round", "make_ppr_round",
    "make_sharded_lanes_fn", "make_sharded_min_round",
    "make_sharded_ppr_round", "make_sharded_ppr_delta_round",
    "make_stacked_lanes_fn", "ppr_base_table",
    "run_ppr_delta_lanes", "run_ppr_lanes", "run_sharded_lanes",
    "run_stacked_lanes",
]
