"""LM command-line entry points (``python -m repro_torch.lm.launch.serve``)."""
