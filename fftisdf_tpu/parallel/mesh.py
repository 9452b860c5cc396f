"""Device-mesh helpers.

The reference has no distributed backend at all (single process, SURVEY.md
section 2c); parallelism here is an original design: a 1D logical mesh
axis "d" over which the two build stages shard along their natural data axes
— the real-space grid for the RHS sweep, the momentum sector q for the solve
+ FFT stage — with one all-to-all (XLA-inserted resharding) between them over the
device interconnect.  This is the device-memory-sharded replacement for the reference's HDF5 out-of-core
spill (``/root/reference/fftisdf.py:60-64``).
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_device_mesh(n_devices=None, devices=None):
    """1D mesh over the available (or given) devices, axis name 'd'."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("d",))


def grid_sharding(mesh):
    """Sharding of (..., ngrid, ...) arrays along the grid axis (axis -2 of
    the (nk, ngrid, nip) RHS)."""
    return NamedSharding(mesh, P(None, "d", None))


def sector_sharding(mesh):
    """Sharding of (nk, ...) arrays along the momentum-sector axis."""
    return NamedSharding(mesh, P("d", None, None))


def replicated(mesh):
    return NamedSharding(mesh, P())
