"""Experiment scripts of the port: counterparts of the TPU experiments in
``benchmarks/``, run as ``python -m distlr_tpu_torch.benchmarks.<name>``."""
