"""Meshes (``repro/launch/mesh.py``): the production shapes over placeholder
ranks (single-pod 16x16, multi-pod 2x16x16) and the one-device host mesh.

The reference builds its production meshes over 512 placeholder XLA
devices. Here a ``DeviceMesh`` of placeholder ranks stands on a process
group of the ``"fake"`` backend (``torch.testing._internal.distributed.
fake_pg``): it runs no collective, and the dry run traces its steps under
``FakeTensorMode``, so nothing is allocated or sent. The host mesh stands
on a real process group of world size 1: ``nccl`` on ``cuda``, ``gloo`` on
``cpu``.

A ``DeviceMesh`` covers the default process group, which is global state:
every function here that makes a mesh first tears down the group that this
module made last, and :func:`release_mesh` (or :func:`mesh_scope`) tears it
down when the caller is done. A default group that something else made is
left alone, and a mesh is then refused. Importing this module touches no
process group.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import resolve_device

#: the default process group this module made, if it is still up
_owned = None


def release_mesh():
    """Tear down the default process group that this module made (no-op
    when there is none)."""
    global _owned
    import torch.distributed as dist
    if _owned is not None and dist.is_initialized() \
            and dist.group.WORLD is _owned:
        dist.destroy_process_group()
    _owned = None


def _mesh(device_type: str, backend: str, store, shape, names):
    global _owned
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    release_mesh()
    if dist.is_initialized():
        raise RuntimeError("a default process group that this module did not "
                           "make is up: tear it down first")
    dist.init_process_group(backend, store=store, rank=0,
                            world_size=int(torch.Size(shape).numel()))
    _owned = dist.group.WORLD
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_placeholder_mesh(shape, names):
    """A ``DeviceMesh`` of ``prod(shape)`` placeholder ranks (this process
    is rank 0) on the ``"fake"`` backend, device type ``cpu``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return _mesh("cpu", "fake", FakeStore(), shape, names)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_placeholder_mesh(shape, axes)


def make_host_mesh(device=None):
    """1x1 ("data", "model") mesh over this process alone: on the card
    (``nccl``) unless ``device`` is the CPU (``gloo``)."""
    import torch.distributed as dist
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    return _mesh(dev.type, backend, dist.HashStore(), (1, 1),
                 ("data", "model"))


@contextlib.contextmanager
def mesh_scope(make, *args, **kwargs):
    """``with mesh_scope(make_production_mesh, multi_pod=True) as mesh:``
    the mesh, its process group torn down on leaving."""
    mesh = make(*args, **kwargs)
    try:
        yield mesh
    finally:
        release_mesh()
