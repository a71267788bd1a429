"""The benchmark of the PyTorch/CUDA port, ``mri_interpolation_tpu_torch``.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints one JSON
line. Everything that belongs to one configuration, cell, per-layer metric
or kernel lives in a file of its own, found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py``, ``kernels/<family>.json``,
and the code paths ``entries/<entry>.py`` and ``models/<model>.py``.
"""
