"""Multi-host initialization and read-shard planning.

The reference is single-process (SURVEY.md §2.4); here multi-host runs use
jax.distributed over several GPU hosts: each host loads its shard of the read
set, spectra are merged with a sorted all-gather, and the replicated-index
DP (parallel/sharded.py) runs over the global mesh.
"""

from __future__ import annotations

import jax
import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """jax.distributed.initialize wrapper; no-op for single-process runs.
    Returns (process_index, process_count)."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_index(), jax.process_count()


def read_shard_bounds(n_reads: int, process_index: int,
                      process_count: int) -> tuple[int, int]:
    """Contiguous per-host read shard (data-parallel axis)."""
    per = -(-n_reads // process_count)
    lo = min(n_reads, process_index * per)
    return lo, min(n_reads, lo + per)


def merge_spectra(local_hi: np.ndarray, local_lo: np.ndarray):
    """Union of per-host spectra via all-gather + host dedup. With one
    process this is a (sorted) no-op. Cross-host transport uses a
    jax.experimental.multihost_utils broadcast when available."""
    if jax.process_count() == 1:
        key = (local_hi.astype(np.uint64) << np.uint64(32)) | local_lo
        key = np.unique(key)
        return ((key >> np.uint64(32)).astype(np.uint32),
                (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    from jax.experimental import multihost_utils
    import jax.numpy as jnp
    # pad to the global max length, all-gather, dedup
    n = np.array([len(local_hi)], np.int32)
    n_all = multihost_utils.process_allgather(jnp.asarray(n))
    n_max = int(np.max(np.asarray(n_all)))
    pad_hi = np.full(n_max, 0xFFFFFFFF, np.uint32)
    pad_lo = np.full(n_max, 0xFFFFFFFF, np.uint32)
    pad_hi[:len(local_hi)] = local_hi
    pad_lo[:len(local_lo)] = local_lo
    all_hi = np.asarray(multihost_utils.process_allgather(jnp.asarray(pad_hi)))
    all_lo = np.asarray(multihost_utils.process_allgather(jnp.asarray(pad_lo)))
    key = (all_hi.astype(np.uint64).reshape(-1) << np.uint64(32)) | all_lo.reshape(-1)
    key = np.unique(key)
    key = key[key != np.uint64(0xFFFFFFFFFFFFFFFF)]
    return ((key >> np.uint64(32)).astype(np.uint32),
            (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))
