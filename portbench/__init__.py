"""The benchmark of the PyTorch and CUDA port (`cortex_tpu_torch`).

`run.py` is the command; README.md says how to run a cell and how to add
a configuration, a traffic mix or a metric. Nothing here imports JAX or
the JAX package.
"""
