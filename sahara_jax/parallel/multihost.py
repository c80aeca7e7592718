"""Multi-host initialization and the cross-host search runner.

The reference has no distributed story (single process, SURVEY.md §2.3);
this module defines the one here:

- ``jax.distributed`` across hosts (coordinator + process ranks);
- every host loads the same index file (no cross-host index traffic) and
  the full query FASTA, then keeps only its contiguous slice of the
  *global* query list (queryIds count revcomp expansions, so slicing
  happens after expansion — search.cpp:121-127 numbering);
- each host searches its slice with **global** queryIds and writes
  ``<output>.h<rank>of<n>``;
- rank order concatenation of the per-host files reproduces the
  single-process canonical output byte-for-byte (global ids are
  contiguous per host and each host's output is sorted by queryId).
"""

from __future__ import annotations

import os

import numpy as np

from sahara_jax.parallel.mesh import DATA_AXIS


def initialize(
    coordinator_address: str | None,
    num_processes: int,
    process_id: int,
    local_device_ids: list[int] | None = None,
) -> None:
    """Initialize jax.distributed (no-op when single-process).

    On GPU hosts nothing tells JAX of the cluster: the coordinator address
    (``host:port``), the process count and this process's rank must all be
    given.  When several processes share one host, ``local_device_ids``
    gives each process its own cards; without it every process would
    claim all of the host's devices."""
    import jax

    if num_processes <= 1:
        return
    if coordinator_address is None:
        raise ValueError("multi-process runs need a coordinator address (host:port)")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_data_mesh():
    """A 1-D data mesh over every device of every host."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (DATA_AXIS,))


def host_query_slice(num_queries: int, rank: int | None = None, n_proc: int | None = None) -> tuple[int, int]:
    """[start, end) of the *global* query range this host should search
    (contiguous block by process rank; hosts still emit global queryIds)."""
    import jax

    rank = jax.process_index() if rank is None else rank
    n_proc = jax.process_count() if n_proc is None else n_proc
    per = -(-num_queries // n_proc)
    start = min(rank * per, num_queries)
    return start, min(start + per, num_queries)


def host_output_path(output: str, rank: int | None = None, n_proc: int | None = None) -> str:
    import jax

    rank = jax.process_index() if rank is None else rank
    n_proc = jax.process_count() if n_proc is None else n_proc
    return f"{output}.h{rank}of{n_proc}"


def merge_host_outputs(paths: list[str], out_path: str) -> None:
    """Concatenate per-host hit files in rank order.

    Contract: per-host files already contain **global** queryIds (each host
    searched queries [start, end) of the global list and emitted those
    ids), so rank-order concatenation equals the single-process canonical
    output (sorted by queryId; slices are contiguous)."""
    with open(out_path, "w") as out:
        for p in paths:
            with open(p) as fh:
                out.write(fh.read())


def merge_on_rank_zero(output: str) -> None:
    """After all hosts wrote their part files (on a shared filesystem),
    rank 0 merges them into ``output``.  Synchronizes across hosts first so
    every part file exists."""
    import jax

    n = jax.process_count()
    if n <= 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("sahara_merge_outputs")
    if jax.process_index() == 0:
        parts = [host_output_path(output, rank=r, n_proc=n) for r in range(n)]
        merge_host_outputs(parts, output)
        for p in parts:
            os.remove(p)
