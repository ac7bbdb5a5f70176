"""The paper's microbenchmarks on the port (``python -m repro_torch.benchmarks.run``)."""
