"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

One command runs one cell once, from the root of a checkout:

    python3 -m fmmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells, configurations and
metrics; ``fmmbench/README.md`` says how to add one by adding files.
"""
