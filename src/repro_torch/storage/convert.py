"""Carry a simulator's state between the reference and the port.

The state of ``repro.storage.RlncSimulator`` is the file, each node's
(coding vectors, payload) and its two random streams: ``np_rng`` (a numpy
generator, whose ``bit_generator.state`` is a plain dict) and ``rng`` (a
``random.Random``, whose ``getstate()`` is a tuple).  With the same state
the port continues bit for bit as the reference would, and back.  For this
system it is the counterpart of converting weights.
"""
from __future__ import annotations

import random
from typing import Dict, Tuple

import numpy as np
import torch

from ..coding import GF8, CodedBlocks
from ..core import CodeParams
from ..device import DeviceLike, resolve_device
from .simulator import RlncSimulator

NodeArrays = Dict[int, Tuple[np.ndarray, np.ndarray]]


def _to_tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(device)


def from_reference_state(params: CodeParams, file_blocks: np.ndarray,
                         nodes: NodeArrays, np_rng_state: dict,
                         py_rng_state: tuple, device: DeviceLike = None,
                         engine: str = "batched") -> RlncSimulator:
    """The port's ``RlncSimulator`` holding the reference's state.

    ``nodes`` maps node id to (vectors, payload) uint8 arrays;
    ``np_rng_state`` is ``np_rng.bit_generator.state`` and ``py_rng_state``
    is ``rng.getstate()`` of the reference simulator.  To continue bit for
    bit, plan on the reference simulator's ``engine``: the engines list a
    tree's edges in another order, and the relays concatenate in it."""
    dev = resolve_device(device)
    bit_gen = getattr(np.random, np_rng_state["bit_generator"])()
    bit_gen.state = np_rng_state
    rng = random.Random()
    rng.setstate(py_rng_state)
    blocks = {i: CodedBlocks(_to_tensor(v, dev), _to_tensor(p, dev))
              for i, (v, p) in nodes.items()}
    return RlncSimulator.from_state(params, _to_tensor(file_blocks, dev),
                                    blocks, np.random.Generator(bit_gen), rng,
                                    field=GF8, device=dev, engine=engine)


def to_reference_state(sim: RlncSimulator
                       ) -> Tuple[np.ndarray, NodeArrays, dict, tuple]:
    """(file_blocks, nodes, np_rng_state, py_rng_state) of ``sim`` as host
    arrays and plain state objects: the inverse of
    :func:`from_reference_state`."""
    nodes = {i: (nd.vectors.cpu().numpy(), nd.payload.cpu().numpy())
             for i, nd in sim.nodes.items()}
    return (sim.file_blocks.cpu().numpy(), nodes,
            sim.np_rng.bit_generator.state, sim.rng.getstate())
