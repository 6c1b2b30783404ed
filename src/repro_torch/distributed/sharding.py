"""Sharding rules for the production meshes, as DTensor placements (the
counterpart of ``repro.distributed.sharding``).

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
multi-pod.  The reference's policy, rule for rule:

  * batch over ("pod", "data"): pure data parallelism across pods, FSDP
    and tensor parallelism inside a pod;
  * parameters 2-D sharded: the "large input" dimension over "data"
    (FSDP; DTensor's sharding propagation inserts the gathers where GSPMD
    does in the reference) and the "parallel" dimension (heads, d_ff,
    experts, vocab) over "model";
  * optimizer state shards exactly like its parameter (Adafactor's
    factored moments are replicated);
  * KV caches: batch over data when divisible, else sequence over data,
    kv-heads over model.

A spec is the reference's PartitionSpec as a tuple: one entry per tensor
dimension, each ``None``, a mesh-axis name, or a tuple of names that split
that one dimension (in mesh order).  :func:`to_placements` turns a spec
into DTensor placements, one per mesh dimension: ``Shard(dim)`` where the
mesh dimension splits tensor dimension ``dim``, ``Replicate()`` where it
splits nothing.  A mesh is anything with ``mesh_dim_names`` and ``shape``
(a ``DeviceMesh``).

Rules are name-based over the port's parameter names (``blocks.<i>.attn.wq``
...): the leaf name picks the rule.  The port keeps one module per layer
where the reference stacks the layers along a leading axis, so each rule
here is the reference's rule for the stacked leaf with the layer axis
dropped; divisibility is judged on the per-layer shape, whose dimensions
are the stacked leaf's remaining ones.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Mapping, Tuple, Union

import torch
from torch.distributed.tensor import Replicate, Shard

if TYPE_CHECKING:
    from ..models.config import ModelConfig

SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> SpecEntry:
    """The batch's entry: ("pod", "data") multi-pod, "data" on one pod."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


def data_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return sizes["data"] * sizes.get("pod", 1)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

_PARAM_RULES: Dict[str, Spec] = {
    # embeddings
    "tok": ("model", None),
    "unembed": ("model", None),
    "patch_proj": (None, "model"),
    "frame_proj": (None, "model"),
    # attention
    "wq": ("data", "model", None),
    "wk": ("data", "model", None),
    "wv": ("data", "model", None),
    "wo": ("model", None, "data"),
    "bq": ("model", None),
    "bk": ("model", None),
    "bv": ("model", None),
    # dense mlp
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    # moe: experts over (pod, model), the expert-ffn dimension over data;
    # the dense trunk never FSDP-gathers expert tables
    "router": (None, "model"),
    "we_gate": (("pod", "model"), None, "data"),
    "we_up": (("pod", "model"), None, "data"),
    "we_down": (("pod", "model"), "data", None),
    # ssd
    "in_proj": ("data", "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "A_log": ("model",),
    "D": ("model",),
    "dt_bias": ("model",),
    "norm_scale": ("model",),
    "out_proj": ("model", "data"),
    # norms
    "scale": (None,),
    "bias": (None,),
}

_EXPERT_LEAVES = ("we_gate", "we_up", "we_down")


def _axis_size(mesh, entry: SpecEntry) -> int:
    if entry is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(entry, str):
        return sizes[entry]
    n = 1
    for a in entry:
        n *= sizes[a]
    return n


def _filter_divisible(mesh, entries: Spec, shape) -> Spec:
    """Placed arguments must divide their dimension exactly: drop the
    entries that do not."""
    return tuple(None if e is not None and shape[i] % _axis_size(mesh, e)
                 else e for i, e in enumerate(entries))


def _keep_present(mesh, entry: SpecEntry) -> SpecEntry:
    """An entry with the axes the mesh lacks dropped (``"pod"`` on one
    pod): ``None`` when nothing is left, one name as the name (as a
    PartitionSpec reads a 1-tuple)."""
    avail = set(mesh.mesh_dim_names)
    if entry is None or isinstance(entry, str):
        return entry if entry is None or entry in avail else None
    kept = tuple(a for a in entry if a in avail)
    return None if not kept else kept[0] if len(kept) == 1 else kept


def param_spec(mesh, name: str, tensor: torch.Tensor,
               fsdp: bool = True) -> Spec:
    """The spec of parameter ``name`` (a dotted module path; the last part
    picks the rule).  ``fsdp=False`` drops "data" from every rule but the
    expert tables' (model-parallel only).  A rank other than the rule's
    is replicated."""
    rule = _PARAM_RULES.get(name.rsplit(".", 1)[-1])
    if rule is None or tensor.dim() != len(rule):
        return ()
    if not fsdp and name.rsplit(".", 1)[-1] not in _EXPERT_LEAVES:
        rule = tuple(None if e == "data" else e for e in rule)
    rule = tuple(_keep_present(mesh, e) for e in rule)
    return _filter_divisible(mesh, rule, tensor.shape)


def local_shape(mesh, spec: Spec, shape) -> Tuple[int, ...]:
    """The shape of one device's shard under ``spec``, by arithmetic (the
    entries divide their dimensions)."""
    return tuple(n // _axis_size(mesh, spec[i] if i < len(spec) else None)
                 for i, n in enumerate(shape))


def to_placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec``: for each mesh dimension in order,
    ``Shard(d)`` if the entry of tensor dimension ``d`` names it, else
    ``Replicate()``.  A tuple entry splits its dimension over several mesh
    dimensions, each ``Shard(d)``, major to minor in mesh order."""
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_specs(mesh, model, fsdp: bool = True) -> Dict[str, Spec]:
    """{parameter name: spec} of a model (or a name -> tensor mapping)."""
    named = (model.named_parameters() if hasattr(model, "named_parameters")
             else model.items())
    return {n: param_spec(mesh, n, p, fsdp) for n, p in named}


def param_shardings(mesh, model, fsdp: bool = True) -> Dict[str, tuple]:
    """{parameter name: placements}."""
    return {n: to_placements(mesh, s)
            for n, s in param_specs(mesh, model, fsdp).items()}


# ---------------------------------------------------------------------------
# batch / cache / activation specs
# ---------------------------------------------------------------------------

def batch_spec(mesh, tensor: torch.Tensor) -> Spec:
    """A batch leaf: its leading (batch) dimension over the batch axes."""
    return _filter_divisible(
        mesh, (batch_axes(mesh),) + (None,) * (tensor.dim() - 1),
        tensor.shape)


def batch_shardings(mesh, batch: Mapping[str, torch.Tensor]
                    ) -> Dict[str, tuple]:
    return {k: to_placements(mesh, batch_spec(mesh, v))
            for k, v in batch.items()}


def cache_spec(mesh, cfg: "ModelConfig", name: str, tensor: torch.Tensor,
               batch_size: int) -> Spec:
    """A cache leaf (``k``, ``v``, ``shared_k``, ``shared_v``: (L|n_app,
    B, S, KV, hd); ``conv``: (L, B, conv-1, C); ``state``: (L, B, Hs, P,
    N)).  When KV does not divide the model axis, head_dim is sharded
    instead; when the batch does not divide the data size, the sequence
    is."""
    ba = batch_axes(mesh)
    shard_batch = batch_size % data_size(mesh) == 0
    if name in ("k", "v", "shared_k", "shared_v"):
        kv_e, hd_e = (("model", None)
                      if cfg.num_kv_heads % axis_sizes(mesh)["model"] == 0
                      else (None, "model"))
        entries = ((None, ba, None, kv_e, hd_e) if shard_batch
                   else (None, None, "data", kv_e, hd_e))
    elif name == "conv":
        entries = (None, ba if shard_batch else None, None, "model")
    elif name == "state":
        entries = (None, ba if shard_batch else None, "model", None, None)
    else:
        entries = (None,) * tensor.dim()
    return _filter_divisible(mesh, entries, tensor.shape)


def cache_shardings(mesh, cfg: "ModelConfig",
                    cache: Mapping[str, torch.Tensor],
                    batch_size: int) -> Dict[str, tuple]:
    return {k: to_placements(mesh, cache_spec(mesh, cfg, k, v, batch_size))
            for k, v in cache.items()}


def replicated(mesh) -> tuple:
    return (Replicate(),) * len(mesh.mesh_dim_names)


def activation_spec(mesh) -> Spec:
    """(B, S, d) hidden-state spec."""
    return (batch_axes(mesh), None, None)


def distribute_model(model: torch.nn.Module, mesh,
                     shardings: Mapping[str, tuple]) -> torch.nn.Module:
    """Replace each parameter of ``model`` by a DTensor of its placements
    on ``mesh`` (in place; returns the model)."""
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(model.named_parameters()):
        prefix, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(prefix), leaf, torch.nn.Parameter(
            distribute_tensor(p.detach(), mesh, shardings[name])))
    return model


def distribute_batch(batch: Mapping[str, torch.Tensor], mesh
                     ) -> Dict[str, torch.Tensor]:
    """A batch as DTensors placed by :func:`batch_shardings`."""
    from torch.distributed.tensor import distribute_tensor
    sh = batch_shardings(mesh, batch)
    return {k: distribute_tensor(v, mesh, sh[k]) for k, v in batch.items()}
