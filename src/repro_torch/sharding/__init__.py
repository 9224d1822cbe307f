from repro_torch.sharding.specs import ShardCtx, spec_for, constrain, RULESETS

__all__ = ["ShardCtx", "spec_for", "constrain", "RULESETS"]
