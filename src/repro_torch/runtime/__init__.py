from repro_torch.runtime.chaos import (
    ChaosEvent, ChaosPlan, FaultDetected, FixpointReport, RecoveryPolicy)
from repro_torch.runtime.elastic import (
    ElasticCoordinator, ShardPool, StragglerMonitor)

__all__ = ["ChaosEvent", "ChaosPlan", "ElasticCoordinator",
           "FaultDetected", "FixpointReport", "RecoveryPolicy",
           "ShardPool", "StragglerMonitor"]
