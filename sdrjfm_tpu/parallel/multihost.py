"""Multi-host ingest: distribute IQ time-slices across hosts into a global array.

The reference's ingest is one host, one producer thread, one ring
(SURVEY.md §2.6).  At multi-host scale each host runs its own native ring
(runtime/native_source — a wav slice, or its own SDR front end) and stages
its *local* contiguous time slice; `jax.make_array_from_process_local_data`
assembles the global `[block_in]` array laid out over the time mesh without
any host ever materialising the whole block.  XLA then moves whatever the
`FullyShardedReceiver` needs between devices (halos, reductions) — the host network carries only
the host→device staging of each host's own slice.

Single-process runs (tests, the 8-device CPU mesh) degenerate to the whole
block being local, so the same code path is exercised everywhere.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "time"


def host_slice(total: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) of the time samples THIS host must stage for a global
    array of `total` samples sharded evenly over the time mesh.

    Matches the device order of `make_global_mesh`: devices (and therefore
    time shards) are laid out in process order, each process holding its
    local devices' contiguous span.
    """
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    assert total % pc == 0, (total, pc)
    per = total // pc
    return pi * per, (pi + 1) * per


def make_global_mesh(axis: str = AXIS) -> Mesh:
    """1-D time mesh over ALL devices of ALL processes, process-major (so
    each host's slice of any P(time) array is contiguous in time)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def global_iq_block(local_iq: np.ndarray, mesh: Mesh,
                    axis: str = AXIS) -> jax.Array:
    """Assemble the per-host time slices into one global device array.

    local_iq : this host's contiguous slice (host_slice of the block),
               any wire format ([t] complex64 or [t, 2] int16/uint8 —
               ReceiverConfig.iq_format)
    Returns a global jax.Array sharded P(axis) over the mesh; no collective
    runs — each host's slice lands on its own devices over its own PCIe,
    the host network is not touched until the compute's own collectives need it.
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, local_iq)
