"""presto_tpu_torch — the presto_tpu SQL engine on PyTorch and CUDA.

The same engine as ``presto_tpu`` (parser, planner, rules, TPC-H
generator and connectors are this package's own copies of those jax-free
modules), with the device tier rewritten for an NVIDIA Hopper card:

- columns are torch tensors on an explicit ``device`` carried by the
  runner and the data source (``exec/columns.py``, ``exec/datasource.py``);
- operators run eagerly, one at a time (``exec/physical.py``), sizing
  their outputs from the data;
- the two Pallas TPU kernels of ``presto_tpu/ops/pallas_kernels.py`` are
  CUDA C++ kernels under ``csrc/`` (``ops/cuda_kernels.py``).

``exec.runner.LocalRunner`` runs on ``cuda`` and raises when no CUDA
device is present unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
