"""The LM stack: architecture configs, the transformer / MoE / Mamba /
xLSTM layers, ``Model`` and its serving CLI.

The graph engine (`core`, `exchange`, `kernels`, `query`, `serve`
admission) imports nothing of this package at module-import time.
Import `repro_torch.lm.*` explicitly from LM entry points (the serve
CLI, `serve.scheduler`, the LM test files) only.
"""
