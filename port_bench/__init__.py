"""The benchmark of qvz_tpu_torch, the PyTorch and CUDA port of QVZ.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output.
"""
