"""The serving benchmark of echr_tpu_torch: one cell a run, data-driven.

``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs the cell ``<name>`` of BENCHMARK.json once and prints one JSON line.
Nothing under this folder imports jax, flax or echr_tpu.
"""
