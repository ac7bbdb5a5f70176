"""pulbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

Run one cell as ``python3 -m pulbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout on a machine with
an NVIDIA card. ``BENCHMARK.json`` at the root names the cells; everything
that belongs to one configuration, traffic mix, cell or per-layer metric
is a file of its own here, found by its name (see ``README.md``).

Nothing in this package imports JAX or the JAX package ``repro``; the plain
reference under ``reference/`` imports nothing of the port either.
"""
