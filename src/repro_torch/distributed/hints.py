"""Activation-sharding hints (the counterpart of
``repro.distributed.hints``).

``hint(x, *spec)`` redistributes a DTensor ``x`` to ``spec`` on the ambient
mesh installed by :func:`set_mesh`.  Spec entries are mesh-axis names (or
tuples of them); axes absent from the ambient mesh are dropped, and mesh
dimensions that no entry names are replicated, as the reference's
``with_sharding_constraint`` does.  Where an entry does not divide its
dimension (GSPMD pads such a shard; DTensor's views refuse uneven ones),
the mesh dimensions it names keep ``x``'s shard of that dimension, if it
has one, and replicate it otherwise.  With no
ambient mesh, or a plain tensor, the call returns ``x`` itself, so model
code carries the production layout while plain runs stay bitwise what
they were.

``BATCH`` expands to ("pod", "data") filtered by the mesh: the canonical
batch sharding.

:func:`replicate_like` is how a module's own tensors (rope tables, masks,
positions, routing indices, chunk tables) join the mesh of a DTensor
input: as ``Replicate()``.  :func:`batch_local` runs a function on each
device's shards (its batch rows, and attention's heads), for computations
that are local to them: the MoE's routing, dispatch and combine (``sort``,
``searchsorted``, indexed scatters, ``scatter_add_``) and the chunked
attention, whose einsums over (batch x heads) DTensor cannot propagate
once both are sharded (a strided shard of the flattened batch).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Iterator, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .sharding import to_placements

BATCH = ("pod", "data")

SpecEntry = Union[None, str, Tuple[str, ...]]

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator[None]:
    """Install ``mesh`` as the ambient mesh for :func:`hint` while the
    block runs."""
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def _filter(axes: Sequence[str], e: SpecEntry) -> SpecEntry:
    if e is None:
        return None
    if isinstance(e, str):
        return e if e in axes else None
    kept = tuple(a for a in e if a in axes)
    return kept if kept else None


def _target(x: DTensor, mesh, spec: Sequence[SpecEntry]) -> tuple:
    """The placements ``spec`` asks of ``x`` on ``mesh``: absent axes
    dropped, unnamed mesh dimensions replicated, and where an entry does
    not divide its dimension (GSPMD pads such a shard; DTensor's views
    refuse uneven ones) the mesh dimensions it names keep ``x``'s
    placement if it shards that same dimension, and replicate
    otherwise."""
    axes = mesh.mesh_dim_names
    entries = [_filter(axes, e) for e in spec]
    placements = list(to_placements(mesh, entries))
    sizes = dict(zip(axes, mesh.shape))
    for dim, e in enumerate(entries):
        names = (e,) if isinstance(e, str) else e or ()
        if x.shape[dim] % math.prod(sizes[a] for a in names):
            for a in names:
                pl = x.placements[axes.index(a)]
                placements[axes.index(a)] = (pl if pl.is_shard(dim)
                                             else Replicate())
    return tuple(placements)


def hint(x: torch.Tensor, *spec: SpecEntry) -> torch.Tensor:
    mesh = _MESH.get()
    if mesh is None or not isinstance(x, DTensor):
        return x
    placements = _target(x, mesh, spec)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def replicate_like(ref: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` on ``ref``'s mesh as ``Replicate()`` when ``ref`` is a DTensor
    (``t`` is the same on every rank), else ``t`` itself."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def gathered(w: DTensor) -> torch.Tensor:
    """The whole of a DTensor parameter on every device, for use inside
    :func:`batch_local`: its local gradient is a partial sum over the
    batch's mesh dimensions (each shard's rows add to it) and the same on
    the others (every device there computes it alike)."""
    from torch.distributed.tensor import Partial
    mesh = w.device_mesh
    rows = to_placements(mesh, (_filter(mesh.mesh_dim_names, BATCH),))
    return w.full_tensor(grad_placements=[
        Partial() if pl.is_shard() else Replicate() for pl in rows])


def batch_local(fn: Callable, *args, spec: Sequence[SpecEntry] = (BATCH,)):
    """``fn(*args)``, run on each device's shards when an argument is a
    DTensor.

    ``fn`` must treat the parts of its tensor arguments that ``spec``
    splits independently: by default the rows (dimension 0, the batch);
    attention also splits the heads.  Each DTensor argument is
    redistributed to ``spec`` (as :func:`hint` reads it; mesh dimensions
    it does not name are replicated), ``fn`` runs on the local shards, and
    each tensor it returns becomes a DTensor of the first DTensor
    argument's placements, its global batch that argument's.  This is
    ``local_map`` with those placements, except for the global shape:
    ``local_map`` infers it from the local one, which is wrong when the
    rows do not divide evenly over the batch axes (a dry run's microbatch
    of 8 rows over 16 data shards)."""
    ref = next((a for a in args if isinstance(a, DTensor)), None)
    if ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    placements = _target(ref, mesh, spec)
    local = [a.redistribute(mesh, _target(a, mesh, spec)).to_local()
             if isinstance(a, DTensor) else a for a in args]
    out = fn(*local)

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        shape = [ref.shape[0]] + list(t.shape[1:])
        for md, pl in enumerate(placements):
            if isinstance(pl, Shard) and pl.dim > 0:
                shape[pl.dim] *= mesh.shape[md]
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(t.contiguous(), mesh, placements,
                                  run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)
