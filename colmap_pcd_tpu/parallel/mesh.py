"""Device mesh construction helpers.

The reference is a single-node C++ application (SURVEY.md §2.10 — its only
"backend" is a thread pool). This build scales over a jax.sharding.Mesh:
one axis ("work") data-parallels independent work items (image pairs in
matching, point blocks in BA); the same axis can span the devices of several
hosts.
"""

from __future__ import annotations

import numpy as np

import jax


def make_mesh(n_devices: int | None = None, axis: str = "work", devices=None) -> jax.sharding.Mesh:
    devs = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.sharding.Mesh(np.asarray(devs), (axis,))


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None, process_id: int | None = None):
    """jax.distributed bring-up for multi-host runs (no-op when single-host)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
