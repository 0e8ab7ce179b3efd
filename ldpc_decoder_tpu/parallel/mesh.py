"""Multi-chip parallelism: frame-batch sharding over a device mesh.

The reference is single-process single-GPU (SURVEY.md §2): its only
parallelism axes are frames and intra-frame edges. Here the frame axis
extends across devices and hosts: every device array in the decoder has frames on
its trailing axis, so the entire decode partitions along one mesh axis
("batch") with *zero* communication inside BP iterations — each frame's
Tanner graph lives whole on one chip. The only cross-chip traffic is the
psum of scalar statistics (frames remaining, error tallies) that XLA inserts
automatically, riding ICI.

Conventions:
- mesh axis name: "batch"
- decode arrays [rows, B]: PartitionSpec(None, "batch")
- per-frame outputs [N, words]: PartitionSpec("batch", None)
- index tables: replicated
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_batch_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), axis_names=("batch",))


def batch_sharding(mesh: Mesh, axis: int, ndim: int) -> NamedSharding:
    """Sharding with 'batch' on the given axis, all others replicated."""
    spec = [None] * ndim
    spec[axis] = "batch"
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch_arrays(mesh: Mesh, tree, batch_axis: int = -1):
    """device_put every array in ``tree`` with 'batch' on ``batch_axis``
    (negative = from the end); scalars/0-d are replicated."""

    def put(x):
        if not hasattr(x, "ndim") or x.ndim == 0:
            return jax.device_put(x, replicated_sharding(mesh))
        ax = batch_axis if batch_axis >= 0 else x.ndim + batch_axis
        return jax.device_put(x, batch_sharding(mesh, ax, x.ndim))

    return jax.tree_util.tree_map(put, tree)
