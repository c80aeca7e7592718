"""Device mesh setup: data-parallel query sharding over replicated index.

The reference has no distribution layer at all (single process, single
thread — SURVEY.md §2.3); this module defines the scaling story here: a
1-D ``data`` mesh axis spanning all devices, index arrays replicated
(``P()``), query batches sharded (``P('data')``), hit reduction via
collectives (SURVEY.md §5.8).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sahara_jax.engine.device import DeviceIndex
from sahara_jax.index.fmindex import FMIndex

DATA_AXIS = "data"


def data_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices of the default
    backend (or of ``devices``).  Too few devices is an error."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (DATA_AXIS,))


def replicate_index(index: FMIndex, mesh: Mesh) -> DeviceIndex:
    """Replicate all index arrays across the mesh (index replicated per
    device, queries sharded)."""
    sharding = NamedSharding(mesh, P())
    return DeviceIndex.from_host(index, sharding=sharding)


def shard_queries(queries: np.ndarray, mesh: Mesh) -> tuple[jax.Array, int]:
    """Pad the query batch to a multiple of the mesh size and shard it along
    the data axis.  Returns (device array [nq_padded, m], original count)."""
    n = mesh.devices.size
    nq, m = queries.shape
    pad = (-nq) % n
    if pad:
        queries = np.concatenate([queries, np.zeros((pad, m), dtype=queries.dtype)], axis=0)
    sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    return jax.device_put(queries, sharding), nq
