"""Per-connection session (reference ``Session``).

Torch port of ``presto_tpu/utils/config.py``, cut to what the port reads:
the schema and the user.  The JAX package's ``EngineConfig`` and its
session properties (``join_distribution_type``, ``hash_partition_count``,
``query_max_run_time_s``, ``pallas_kernels``, ``fused_execution``) steer
nothing in the port, so it has none of them: the statement server refuses
a session property rather than accept one it would ignore, and a CUDA
tensor always launches its kernel (``ops/cuda_kernels.py``), so there is
no kernel switch.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Session:
    """The schema a connection plans against and the user it runs as."""

    schema: str = "tiny"
    user: str = "presto_tpu"
