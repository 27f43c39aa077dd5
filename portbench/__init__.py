"""Benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves one cell of ``BENCHMARK.json`` through
``repro_torch.serving.AsyncCluster`` and prints one JSON result line.
Configurations, traffic mixes, cells and metric readers are files under
this folder, found by the names ``BENCHMARK.json`` gives them.
"""
