"""Multi-host initialization helpers.

The distributed layer (distributed.py) is mesh-agnostic: it works the same
over a single-host multi-chip mesh, a multi-host pod slice, or a virtual CPU
mesh.  This module provides the thin glue for the multi-host case: call
:func:`init` once per process before building meshes; collectives between
shards on the same host ride the host's device links (NVLink on an H200
host), cross-host edges of the same mesh axis ride the network -- XLA picks
per edge, no code changes needed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["init", "global_row_mesh", "cpu_local_cluster", "replicate"]


def cpu_local_cluster(num_local_devices: int = 4) -> None:
    """Configure THIS process as one member of a multi-process CPU cluster.

    The standard JAX recipe for testing multi-host code without a pod:
    every participating process calls this, then :func:`init` with the same
    coordinator and its own ``process_id``; the processes federate into one
    cluster whose global device count is ``num_processes x
    num_local_devices``, and cross-process collectives run over gloo (the
    DCN stand-in).  Must run before any array is created.

    Exercised end to end by ``tests/test_multihost.py``: two OS processes,
    eight global devices, halo ``ppermute``s crossing the process boundary.
    """
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", num_local_devices)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")


def replicate(a, mesh):
    """Host array -> globally-replicated jax.Array on ``mesh``.

    Multi-process meshes contain non-addressable devices; plain
    ``jnp.asarray`` yields a process-local array that collective programs
    reject.  Every process must call this with the SAME host values (the
    standard same-on-all-hosts contract).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.device_put(
        np.asarray(a), NamedSharding(mesh, PartitionSpec())
    )


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> None:
    """Initialize jax.distributed for a multi-host run.

    Pass all arguments explicitly where nothing tells JAX of the cluster
    (e.g. ``coordinator_address="localhost:<port>"`` on one host).  Safe to call once per process;
    raises if called twice.
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_row_mesh(axis: str = "rows"):
    """1-D mesh over every addressable device in the job (all hosts)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))
