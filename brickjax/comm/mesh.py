"""Mesh helpers: the jax.sharding analog of MPI_Cart_create
(ref: weak/args.cpp:105-108, brick-mpi.h:730-753)."""

from __future__ import annotations

import numpy as np

import jax


DEFAULT_AXIS_NAMES = ("w", "z", "y", "x")  # outermost-first domain axes


def domain_axis_names(ndim: int) -> tuple[str, ...]:
    if ndim <= len(DEFAULT_AXIS_NAMES):
        return DEFAULT_AXIS_NAMES[-ndim:]
    # rank > 4 (the layout/oracle path is dim-generic like the
    # reference's templates): extra leading axes get generated names
    extra = tuple(f"d{a}" for a in range(ndim - len(DEFAULT_AXIS_NAMES)))
    return extra + DEFAULT_AXIS_NAMES


def make_domain_mesh(mesh_shape, names=None, devices=None):
    """A Mesh whose axes map one-to-one onto domain axes (outermost
    first).  Axes of size 1 keep undistributed dims addressable so the
    same exchange code runs at any device count (periodic wrap on a
    1-device axis exchanges with itself — the reference's np=1 trick)."""
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if names is None:
        names = domain_axis_names(len(mesh_shape))
    if devices is None:
        n = int(np.prod(mesh_shape))
        devs = jax.devices()
        if len(devs) < n:
            raise ValueError(f"mesh {mesh_shape} needs {n} devices, "
                             f"have {len(devs)} {devs[0].platform}")
        devices = np.asarray(devs[:n]).reshape(mesh_shape)
    return jax.sharding.Mesh(devices, names)


def make_multislice_mesh(slices: int, mesh_shape, names=None,
                         devices=None, slice_name="slice"):
    """A TWO-LEVEL mesh: ``slices`` nodes x a mesh of ``mesh_shape``
    cards per node (the reference runs on arbitrary rank topologies via
    MPI_Cart_create, weak/args.cpp:105-108).

    The node axis composes with the OUTERMOST domain axis: domain axis
    0 is distributed over ``slices * mesh_shape[0]`` devices,
    node-major, so exchanges along it cross a node boundary exactly
    once per shift (XLA picks the transport from device placement; the
    exchange code just names the composite axis).

    Returns ``(mesh, xnames, eff_shape)``: the Mesh (axes
    ``(slice_name,) + domain names``), the per-DOMAIN-axis ppermute
    axis names (axis 0 is the composite ``(slice_name, name0)`` tuple),
    and the per-domain-axis effective device counts."""
    slices = int(slices)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if names is None:
        names = domain_axis_names(len(mesh_shape))
    full_shape = (slices,) + mesh_shape
    if devices is None:
        n = int(np.prod(full_shape))
        devs = jax.devices()
        if len(devs) < n:
            raise ValueError(f"mesh {full_shape} needs {n} devices, "
                             f"have {len(devs)} {devs[0].platform}")
        devices = np.asarray(devs[:n]).reshape(full_shape)
    mesh = jax.sharding.Mesh(devices, (slice_name,) + tuple(names))
    xnames = ((slice_name, names[0]),) + tuple(names[1:])
    eff = (slices * mesh_shape[0],) + mesh_shape[1:]
    return mesh, xnames, eff


def shard_map(f, mesh, in_specs, out_specs):
    """``jax.shard_map`` with varying-axes checks off: the custom-VJP
    pullbacks build masks and zero cotangents that carry no
    varying-mesh-axes annotation."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
