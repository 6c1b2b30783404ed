#!/usr/bin/env python3
"""Which in-place writes into a sharded KV cache the installed torch's
DTensor accepts: a slice at an int position, an indexed write
(``index_put_``), ``index_copy_`` and ``scatter_`` at a tensor position.

    python3 scripts/dtensor_cache_write.py

On a fake 2x2 process group (no data moves, so only whether each write
runs and which collectives it issues is read): a (4, 16, 4, 8) cache
sharded over the batch and the heads, as ``distributed.sharding`` places
it, and over the sequence and the heads (a batch that does not divide the
data axis); writes of 1 and of 5 positions.  Prints one line a case.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.debug import CommDebugMode
from torch.testing._internal.distributed.fake_pg import FakeStore

B, S_MAX, KV, HD, AT = 4, 16, 4, 8, 3


def write(kind: str, kc, k, at) -> None:
    S = k.shape[1]
    if kind == "slice":
        kc[:, AT:AT + S] = k
    elif kind == "index_put_":
        kc[:, at] = k
    elif kind == "index_copy_":
        kc.index_copy_(1, at, k)
    else:
        kc.scatter_(1, at[None, :, None, None].expand(B, S, KV, HD), k)


def main() -> int:
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for layout, pl in (("batch,heads", (Shard(0), Shard(2))),
                       ("seq,heads", (Shard(1), Shard(2)))):
        for S in (1, 5):
            for kind in ("slice", "index_put_", "index_copy_", "scatter_"):
                kc = distribute_tensor(torch.zeros(B, S_MAX, KV, HD), mesh,
                                       pl)
                k = distribute_tensor(torch.ones(B, S, KV, HD), mesh,
                                      (Shard(0), Shard(2)))
                at = DTensor.from_local(torch.arange(S) + AT, mesh,
                                        (Replicate(), Replicate()),
                                        run_check=False)
                try:
                    with CommDebugMode() as comm:
                        write(kind, kc, k, at)
                    said = (f"runs, placements {kc.placements}, collectives "
                            f"{dict(comm.get_comm_counts()) or 'none'}")
                except Exception as e:      # the write is refused
                    said = (f"refused: {type(e).__name__}: "
                            f"{str(e).splitlines()[0][:120]}")
                print(f"torch {torch.__version__}, cache over {layout}, "
                      f"{S} position(s), {kind}: {said}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
