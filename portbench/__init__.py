"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``,
read by the generator it names in ``generators/``), the way the program
is built and driven (``systems/<system>.py``), the plain reference
(``reference/<config>.py``) and one reader a metric
(``metrics/<metric>.py``). Nothing here imports JAX or the JAX package.
"""
