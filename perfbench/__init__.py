"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run of
one cell, ``python3 -m perfbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``perfbench/run.py``)."""
