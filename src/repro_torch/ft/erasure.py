"""Erasure coding of checkpoint trees into per-host shards (the counterpart
of ``repro.ft.erasure``).

A checkpoint (a tree of tensors: parameters, optimizer state, the step) is
laid out as one byte buffer, split into M equal blocks and RLNC-encoded
into n * alpha coded blocks over a *recovery group* of n hosts (alpha =
M/k each, the MSR layout).  Any k hosts reconstruct; a lost host is
regenerated from d survivors with the paper's planners instead of a full
reconstruction.

The buffer and the shards stay on the coder's device: the leaves are
copied straight into one zero-padded (M, block_bytes) buffer there (no
host round trip, no second copy for the padding), and a restore cuts the
leaves back out of the reconstructed buffer as views.

The leaf order is the reference's: ``jax.tree_util`` visits a dict's keys
sorted, an ``OrderedDict``'s (a ``state_dict``) in insertion order, lists
and tuples in order, and takes ``None`` as an empty subtree.  The same
state therefore gives the same bytes, and with the same seed the same
shards, as the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..coding import GF8, RLNC, CodedBlocks
from ..coding.rlnc import Matmul
from ..core import CodeParams
from ..device import DeviceLike, resolve_device
from ..obs import spans


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a tree without its leaves: ``kind`` is "leaf",
    "none", "dict", "odict", "list", "tuple" or "namedtuple"; ``keys`` the
    dict keys in leaf order; ``children`` the subtrees; ``cls`` a
    namedtuple's class (``jax.tree_util`` keeps it, so a restored
    ``OptState`` is an ``OptState``)."""
    kind: str
    keys: Tuple[Any, ...] = ()
    children: Tuple["TreeDef", ...] = ()
    cls: Optional[type] = None


_LEAF = TreeDef("leaf")


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """The leaves in ``jax.tree_util`` order, and the structure."""
    if tree is None:
        return [], TreeDef("none")
    if isinstance(tree, dict):
        ordered = isinstance(tree, collections.OrderedDict)
        keys = tuple(tree) if ordered else tuple(sorted(tree))
        vals = [tree[k] for k in keys]
        kind = "odict" if ordered else "dict"
    elif isinstance(tree, (list, tuple)):
        keys, vals = (), list(tree)
        kind = "list" if isinstance(tree, list) else "tuple"
        if hasattr(tree, "_fields"):
            kind = "namedtuple"
    else:
        return [tree], _LEAF
    leaves, children = [], []
    for v in vals:
        lv, td = tree_flatten(v)
        leaves += lv
        children.append(td)
    return leaves, TreeDef(kind, keys, tuple(children),
                           type(tree) if kind == "namedtuple" else None)


def tree_unflatten(treedef: TreeDef, leaves: Sequence[Any]) -> Any:
    return _build(treedef, iter(leaves))


def _build(td: TreeDef, it) -> Any:
    # a module-level function: a recursive closure would be a reference
    # cycle holding the leaves (a restored buffer) until the collector ran
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    vals = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.keys, vals))
    if td.kind == "odict":
        return collections.OrderedDict(zip(td.keys, vals))
    if td.kind == "namedtuple":
        return td.cls(*vals)
    return vals if td.kind == "list" else tuple(vals)


@dataclasses.dataclass
class TreeSpec:
    """Enough structure to rebuild the tree from bytes."""
    treedef: TreeDef
    shapes: List[Tuple[int, ...]]
    dtypes: List[torch.dtype]
    sizes: List[int]          # byte length per leaf
    total_bytes: int


def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, DTensor):
        raise TypeError("a checkpoint takes plain tensors; this state holds "
                        "a DTensor (a sharded state is not checkpointed: "
                        "gather it with full_tensor() first)")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.array(leaf))


def tree_to_bytes(tree: Any, device: DeviceLike = None, blocks: int = 1
                  ) -> Tuple[torch.Tensor, TreeSpec]:
    """The leaves' bytes, in leaf order, in one uint8 buffer on ``device``
    (``cuda`` unless ``"cpu"`` is named), zero-padded to a multiple of
    ``blocks`` bytes (no padding with the default 1).  ``spec.total_bytes``
    is the unpadded length.  The call is the span ``ckpt.flatten``."""
    with spans.span("ckpt.flatten"):
        return _tree_to_bytes(tree, resolve_device(device), blocks)


def _tree_to_bytes(tree: Any, dev: torch.device, blocks: int
                   ) -> Tuple[torch.Tensor, TreeSpec]:
    leaves, treedef = tree_flatten(tree)
    tensors = [_as_tensor(leaf) for leaf in leaves]
    sizes = [t.numel() * t.element_size() for t in tensors]
    total = sum(sizes)
    padded = math.ceil(total / blocks) * blocks
    buf = torch.empty(padded, dtype=torch.uint8, device=dev)
    buf[total:].zero_()
    off = 0
    for t, size in zip(tensors, sizes):
        buf[off:off + size].copy_(t.contiguous().reshape(-1)
                                  .view(torch.uint8))
        off += size
    spec = TreeSpec(treedef=treedef, shapes=[tuple(t.shape) for t in tensors],
                    dtypes=[t.dtype for t in tensors], sizes=sizes,
                    total_bytes=total)
    return buf, spec


def bytes_to_tree(buf: torch.Tensor, spec: TreeSpec) -> Any:
    """The tree of ``spec`` with its leaves cut out of ``buf`` (a uint8
    tensor), on ``buf``'s device.  A leaf is a view of ``buf`` where its
    offset is a multiple of its element size, else a copy (a tensor view
    must be aligned to its dtype)."""
    out, off = [], 0
    for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        seg = buf[off:off + size]
        if (buf.storage_offset() + off) % dtype.itemsize:
            seg = seg.clone()
        out.append(seg.view(dtype).reshape(shape))
        off += size
    return tree_unflatten(spec.treedef, out)


@dataclasses.dataclass
class EncodedGroup:
    """One recovery group: n host shards of an (n, k, d)-coded buffer."""
    params: CodeParams
    block_bytes: int
    payload_bytes: int                  # original length (pre-padding)
    shards: Dict[int, CodedBlocks]      # host id -> alpha coded blocks

    def live_hosts(self) -> List[int]:
        return sorted(self.shards)


class ErasureCoder:
    """The (n, k, d) MSR code of a recovery group, on one device (``cuda``
    unless ``"cpu"`` is named; raises without CUDA).  Its coefficient draws
    come from ``np.random.default_rng(seed)`` as in the reference; every
    product runs through ``matmul`` (the GF(2^8) kernel on the card by
    default)."""

    def __init__(self, n: int = 8, k: int = 4, d: int = 6,
                 blocks_per_host: int = 16, seed: int = 0,
                 device: DeviceLike = None, matmul: Optional[Matmul] = None):
        # MSR layout: alpha = M/k blocks per host
        self.n, self.k, self.d = n, k, d
        self.alpha = blocks_per_host
        self.M = self.alpha * k
        self.rl = RLNC(GF8, matmul=matmul, device=device)
        self.device = self.rl.device
        self.rng = np.random.default_rng(seed)

    def encode(self, buf: torch.Tensor, hosts: Sequence[int],
               payload_bytes: Optional[int] = None) -> EncodedGroup:
        """Encode the uint8 buffer ``buf`` over ``hosts``.  ``payload_bytes``
        is its unpadded length (all of it by default); a buffer already
        padded to M * ceil(payload_bytes / M) bytes, as ``tree_to_bytes``
        gives with ``blocks=M``, is used without a copy.  The call is the
        span ``ckpt.encode``."""
        with spans.span("ckpt.encode"):
            return self._encode(buf, hosts, payload_bytes)

    def _encode(self, buf: torch.Tensor, hosts: Sequence[int],
                payload_bytes: Optional[int]) -> EncodedGroup:
        assert len(hosts) == self.n
        payload = len(buf) if payload_bytes is None else payload_bytes
        block_bytes = math.ceil(payload / self.M)
        buf = buf.to(self.device)
        if len(buf) == block_bytes * self.M:
            padded = buf
        else:
            padded = torch.zeros(block_bytes * self.M, dtype=torch.uint8,
                                 device=self.device)
            padded[:payload] = buf[:payload]
        blocks = padded.view(self.M, block_bytes)
        node_blocks = self.rl.distribute(blocks, self.n, self.alpha, self.rng)
        params = CodeParams(n=self.n, k=self.k, d=self.d, M=float(self.M),
                            alpha=float(self.alpha))
        return EncodedGroup(params=params, block_bytes=block_bytes,
                            payload_bytes=payload,
                            shards=dict(zip(hosts, node_blocks)))

    def reconstruct(self, group: EncodedGroup,
                    hosts: Optional[Sequence[int]] = None) -> torch.Tensor:
        hosts = list(hosts) if hosts is not None else group.live_hosts()[: self.k]
        nodes = [group.shards[h] for h in hosts]
        blocks = self.rl.reconstruct(nodes, self.M)
        return blocks.reshape(-1)[: group.payload_bytes]
