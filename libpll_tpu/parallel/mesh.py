"""Device meshes and site-axis sharding.

The reference is single-threaded C with SIMD over sites (SURVEY §2.4); the
device equivalent is data parallelism over the *sites* axis of every
per-site array across all devices of a mesh: CLVs ``[node, rate, state, sites]``,
scalers, pattern weights, invariant indices and per-site log-likelihoods are
sharded on their last axis, while P-matrices, eigen data and frequencies are
tiny and replicated. The phylogenetic likelihood is exactly decomposable over
sites, so the only cross-device communication is the final weighted log-sum
(a psum of one scalar — or of (L, L', L'') triples during Newton), which XLA
inserts automatically under jit when reductions cross the sharded axis.

Multi-host: call :func:`initialize_distributed` once per process; the mesh
then spans all processes' devices and the routing between them is XLA's
concern.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SITES_AXIS = "sites"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (`jax.distributed.initialize`); no-op when the
    arguments are None and the environment is single-process."""
    if coordinator_address is None and num_processes in (None, 1):
        return
    jax.distributed.initialize(coordinator_address, num_processes, process_id)


def make_sites_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over all (local+remote) devices with a single 'sites' axis."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (SITES_AXIS,))


def sites_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for arrays whose LAST axis is sites."""
    return NamedSharding(mesh, P(*([None] * 0), SITES_AXIS))


def sharding_for_rank(mesh: Mesh, ndim: int) -> NamedSharding:
    """NamedSharding placing the last of ``ndim`` axes on the sites axis."""
    spec = [None] * (ndim - 1) + [SITES_AXIS]
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_sites(n_sites: int, mesh: Mesh) -> int:
    """Sites must divide evenly across the mesh; pad with weight-0 columns."""
    n = mesh.shape[SITES_AXIS]
    return ((n_sites + n - 1) // n) * n


def shard_partition(partition, mesh: Mesh) -> None:
    """Re-place an existing Partition's device arrays onto the mesh:
    site-sharded bulk arrays, replicated P-matrices.

    The partition's ``sites_alloc`` must be divisible by the mesh size
    (create it with ``sites = pad_sites(...)`` and zero pattern weights in
    the pad, mirroring how the reference pads SIMD widths with zero-weight
    columns).
    """
    partition.place_clv(sharding_for_rank(mesh, len(partition.clv_shape)))
    partition.scalers = jax.device_put(
        partition.scalers, sharding_for_rank(mesh, partition.scalers.ndim))
    partition.pmatrix = jax.device_put(partition.pmatrix, replicated(mesh))
