"""Device mesh helpers for multi-chip TCI.

The parallelism axis in TCI is the function-sample batch (SURVEY.md §2.5):
pivot-panel sampling is embarrassingly parallel over assembled index rows, so
we shard that batch over a 1-D mesh and let XLA gather the panel over the
device interconnect. The LU elimination itself is replicated (it is tiny
compared to sampling for expensive integrands).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def default_mesh(n_devices: Optional[int] = None, axis: str = "batch") -> Mesh:
    """1-D mesh over the first `n_devices` devices of the default platform.

    Raises ValueError when the default platform has fewer devices than
    requested; a CPU mesh is built only where the CPU is the default platform
    (e.g. ``JAX_PLATFORMS=cpu`` with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=N``).
    """
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but the default "
                f"platform ({devices[0].platform}) has {len(devices)} "
                "devices; for a virtual CPU mesh run with JAX_PLATFORMS=cpu "
                "and XLA_FLAGS=--xla_force_host_platform_device_count=N"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))
