"""The dry run of every (architecture x shape x mesh) cell against the
production meshes (the counterpart of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \\
        --multi-pod --out build/dryrun/cell.json
    python -m repro_torch.launch.dryrun --all    (a process per cell,
                                                  resumable from the JSON
                                                  files in build/dryrun/)

This is the one entry point of the port that runs on ``meta`` and on the
host: it builds the cell's model on ``meta`` (``launch.specs``), places it
with ``param_shardings`` on a 16x16 or 2x16x16 mesh over a ``fake``
process group (``launch.mesh``, rank 0 of 256 or 512), and runs the cell's
step once under ``FakeTensorMode``: every tensor is abstract, DTensor's
sharding propagation and redistributions run as they would on the mesh,
and no collective moves data.  It opens no CUDA context.

The step, as the reference lowers it: train is one microbatch's forward
and backward plus the optimizer update (``make_train_step`` with
``grad_shardings``; the microbatch is the batch's rows over
``TRAIN_MICROBATCHES``, sharded over the batch axes and padded up to a
multiple of them where they do not divide, as GSPMD pads it in the
reference's lowering: kimi-k2's 8 rows take 16 over 16 data shards);
prefill and decode are ``make_prefill_step`` and
``make_decode_step`` (decode at the cache's last position).  The
reference's per-cell policy is kept: its config overrides (single-tile
attention and repeated KV heads for training, the loss chunk), FSDP for
qwen2.5-14b and pixtral-12b only, Adafactor with bf16 gradients above 2e11
parameters.

Reported per device (rank 0):

* memory: argument bytes from the local shard shapes of the parameters,
  the optimizer state, the gradient accumulator, the batch and the cache
  (exact), beside the same sum by arithmetic on the specs; temp bytes from
  ``MemTracker`` over the step (everything the step allocates: gradients,
  the accumulator, activations, collectives' buffers); the peak as
  arguments plus temp, the accumulator once, against the card's 80 GB;
* FLOPs: ``FlopCounterMode`` over the step (matmuls; remat's recompute
  included), beside the reference's ``model_flops_per_device`` and their
  ratio, ``useful_fraction``;
* HBM bytes: the bytes every non-view op reads and writes on the local
  shards (eager PyTorch, no fusion);
* collectives: counts, bytes and ring-model link bytes per kind, counted
  as ``CommDebugMode`` counts them (``launch.roofline``).  DTensor lowers
  a Shard-to-Shard redistribution on a CPU mesh to an all-gather; the dry
  run calls its all-to-all op instead, so it is counted as one;
* roofline: ``launch.roofline.roofline_terms`` on the H100's rates.

For a train cell the microbatches are alike, so the step's FLOPs, HBM
bytes and collectives are the update's plus ``n_micro`` times the rest of
the measured step (the update is measured alone, once).  A cell whose step
fails records ``{"ok": false, "error": ...}``; no number is estimated in
its place.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Iterator, Optional

import torch

from . import roofline

ARTIFACT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun"

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def _comm_mode():
    """A dispatch mode that records, per collective kind, the calls, the
    bytes of each call's buffer (the output; the input for an all-to-all)
    and the ring-model link bytes, and the bytes every other non-view op
    reads and writes on the local shards.  (``CommDebugMode`` counts the
    same collectives but tracks modules too, and refuses a module called
    twice in one step: zamba2's shared attention blocks.)"""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def nbytes(x) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(x)
                   if isinstance(t, torch.Tensor))

    class CommBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = collections.Counter()
            self.size = collections.Counter()
            self.link = collections.Counter()
            self.op_bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented       # DTensor runs, then its locals
            out = func(*args, **(kwargs or {}))
            if not hasattr(func, "_schema"):
                return out
            kind = _COLLECTIVES.get(func._overloadpacket.__name__)
            if kind is not None:
                group = args[-1]
                n = (_resolve_process_group(group).size()
                     if isinstance(group, str) else group.size())
                size = nbytes(args[0] if kind == "all-to-all" else out)
                self.calls[kind] += 1
                self.size[kind] += size
                self.link[kind] += roofline.link_bytes(kind, size, n)
            elif not func.is_view:
                self.op_bytes += nbytes(args) + nbytes(kwargs) + nbytes(out)
            return out

    return CommBytes()


@contextlib.contextmanager
def _native_all_to_all() -> Iterator[bool]:
    """DTensor's Shard-to-Shard redistribution as its all-to-all op on a
    CPU mesh (where it otherwise falls back to an all-gather and a chunk,
    for gloo).  Under ``FakeTensorMode`` the op runs its shape function
    only.  Yields whether the private names were found."""
    try:
        from torch.distributed.tensor import placement_types as pt
        from torch.distributed._functional_collectives import \
            _resolve_group_name
        op = torch.ops._dtensor.shard_dim_alltoall
        saved = pt.shard_dim_alltoall
    except (ImportError, AttributeError):
        yield False
        return

    def native(input, gather_dim, shard_dim, mesh, mesh_dim):
        return op(input, gather_dim, shard_dim,
                  _resolve_group_name((mesh, mesh_dim)))

    pt.shard_dim_alltoall = native
    try:
        yield True
    finally:
        pt.shard_dim_alltoall = saved


@contextlib.contextmanager
def _quiet_propagation() -> Iterator[None]:
    """DTensor's sharding propagation runs each new op once on global
    shapes (under a fake mode) to learn its output's metadata; run that
    with the measuring modes off, so they see only the local ops."""
    from torch.distributed.tensor._sharding_prop import \
        ShardingPropagator as SP
    from torch.utils._python_dispatch import _disable_current_modes
    saved = SP._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes():
            return saved(self, op_schema)

    SP._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        SP._propagate_tensor_meta_non_cached = saved


def cell_config(arch: str, shape_name: str,
                overrides: Optional[Dict[str, Any]] = None):
    """(cfg, shape) with the reference's per-cell config overrides."""
    from ..configs import get_config
    from ..models.config import SHAPES

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    merged: Dict[str, Any] = {}
    if shape.kind == "train" and cfg.has_attention:
        tile = min(shape.seq_len, 4096)
        merged.update(q_chunk=tile, kv_chunk=tile)
        if 0 < cfg.num_kv_heads < 16 <= cfg.num_heads:
            merged.update(repeat_kv=True)
    if shape.kind == "train":
        merged.update(loss_chunk=min(2048, cfg.loss_chunk * 4)
                      if cfg.vocab_size > 100_000 else 2048)
    merged.update(overrides or {})
    return dataclasses.replace(cfg, **merged), shape


def model_flops_per_device(cfg, shape, chips: int) -> float:
    """The useful-compute yardstick: 6 N D (train), 2 N D (prefill), 2 N B
    (decode) over the chips, N the active parameters."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        flops = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        flops = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        flops = 2.0 * n_active * shape.global_batch
    return flops / chips


def _local_bytes(tensors) -> int:
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tensors)


def _analytic_bytes(mesh, specs) -> int:
    """Sum of (shape, spec, dtype) shards' bytes by spec arithmetic."""
    from ..distributed.sharding import local_shape
    total = 0
    for shape, spec, dtype in specs:
        n = 1
        for x in local_shape(mesh, spec, shape):
            n *= x
        total += n * torch.empty((), dtype=dtype).element_size()
    return total


def _place(tensors: Dict[str, torch.Tensor], mesh, shardings) -> Dict:
    """Abstract copies of ``tensors`` (``meta``) placed on ``mesh`` by
    ``shardings`` (name -> placements); run under ``FakeTensorMode``."""
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(torch.empty(v.shape, dtype=v.dtype), mesh,
                                 shardings[k]) for k, v in tensors.items()}


def _mem_tracker():
    """``MemTracker`` for its device totals only: its per-module
    statistics refuse a module called twice in one step (zamba2's shared
    attention blocks), so its module hooks do nothing here."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Totals(MemTracker):
        def _pre_fw_hook(self, module, inputs):
            pass

        def _post_fw_hook(self, module, inputs, outputs):
            pass

        def _pre_bw_hook(self, module, args):
            pass

        def _post_bw_hook(self, module, args):
            pass

    return Totals()


def _measure(fn) -> Dict[str, Any]:
    """Run ``fn()`` once under the FLOP counter and the collective
    recorder."""
    from torch.utils.flop_counter import FlopCounterMode
    comm = _comm_mode()
    with FlopCounterMode(display=False) as fc, comm:
        fn()
    return {"flops": float(fc.get_total_flops()),
            "hbm_bytes": float(comm.op_bytes), "calls": dict(comm.calls),
            "bytes": dict(comm.size), "link": dict(comm.link)}


def _combine(step: Dict, update: Dict, n_micro: int) -> Dict:
    """``update + n_micro * (step - update)``, key by key."""
    def comb(a, b):
        return b + n_micro * (a - b)
    out = {k: comb(step[k], update[k]) for k in ("flops", "hbm_bytes")}
    for k in ("calls", "bytes", "link"):
        kinds = set(step[k]) | set(update[k])
        out[k] = {kind: comb(step[k].get(kind, 0), update[k].get(kind, 0))
                  for kind in kinds}
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One cell's record (see the module docstring); ``ok`` is false, with
    the error, if its step failed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..distributed import (batch_shardings, batch_spec, cache_shardings,
                               cache_spec, data_size, param_shardings,
                               param_specs, set_mesh)
    from ..ft.erasure import tree_flatten
    from ..models import embed_inputs, forward_hidden
    from ..models.layers import _DTYPES
    from ..train.optimizer import OptimizerConfig, init_opt, apply_updates
    from ..train.step import (make_decode_step, make_prefill_step,
                              make_train_step)
    from .mesh import make_production_mesh, teardown
    from .specs import TRAIN_MICROBATCHES, input_specs

    cfg, shape = cell_config(arch, shape_name, overrides)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_name}
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        chips = mesh.size()
        result["chips"] = chips
        specs = input_specs(cfg, shape)
        meta_model = specs["params"]
        fsdp = arch in ("qwen2.5-14b", "pixtral-12b")
        huge = cfg.param_count() > 2e11
        named = dict(meta_model.named_parameters())
        pspecs = param_specs(mesh, meta_model, fsdp=fsdp)
        param_sh = param_shardings(mesh, meta_model, fsdp=fsdp)
        n_micro = TRAIN_MICROBATCHES.get(arch, 4)
        if shape.kind == "train":       # one microbatch's rows, padded
            rows = shape.global_batch // n_micro
            dsize = data_size(mesh)
            rows = -(-rows // dsize) * dsize
            micro = {k: torch.empty((rows,) + v.shape[1:], dtype=v.dtype,
                                    device="meta")
                     for k, v in specs["batch"].items()}
        with FakeTensorMode(), set_mesh(mesh), \
                _native_all_to_all() as native_a2a, _quiet_propagation():
            model = meta_model
            for name, p in _place(named, mesh, param_sh).items():
                prefix, _, leaf = name.rpartition(".")
                setattr(model.get_submodule(prefix), leaf,
                        torch.nn.Parameter(p))
            arg_tensors = list(model.parameters())
            analytic = [(p.shape, pspecs[n], p.dtype)
                        for n, p in named.items()]
            extra_tracked = []
            if shape.kind == "train":
                opt_cfg = (OptimizerConfig(mode="adafactor", momentum=False,
                                           state_dtype="float32",
                                           grad_dtype="bfloat16")
                           if huge else OptimizerConfig())
                opt = init_opt(opt_cfg, model, device="cpu")
                opt_leaves = tree_flatten(opt)[0]
                arg_tensors += opt_leaves
                gdt = _DTYPES[opt_cfg.grad_dtype]
                for n, p in named.items():
                    if opt_cfg.mode == "adamw":     # m and v, like p
                        analytic += [(p.shape, pspecs[n], torch.float32)] * 2
                    analytic.append((p.shape, pspecs[n], gdt))   # the acc.
                analytic += ([(t.shape, (), t.dtype) for t in opt_leaves]
                             if opt_cfg.mode == "adafactor"
                             else [((), (), torch.int32)])        # the step
                acc_bytes = sum(_local_bytes([p]) // p.element_size()
                                * gdt.itemsize for p in model.parameters())
                batch = specs["batch"]
                placed = _place(batch, mesh, batch_shardings(mesh, batch))
                micro = _place(micro, mesh, batch_shardings(mesh, batch))
                arg_tensors += list(placed.values())
                analytic += [(v.shape, batch_spec(mesh, v), v.dtype)
                             for v in batch.values()]
                extra_tracked = list(micro.values())
                step = make_train_step(cfg, opt_cfg, n_micro=1,
                                       grad_shardings=param_sh)

                def run():
                    step(model, opt, micro)

                def update():
                    grads = {n: torch.zeros_like(p, dtype=torch.float32)
                             for n, p in model.named_parameters()}
                    apply_updates(opt_cfg, model, grads, opt)
            else:
                acc_bytes = 0
                batch = specs.get("batch")
                cache = specs.get("cache")
                placed = (_place(batch, mesh, batch_shardings(mesh, batch))
                          if batch is not None else {})
                pcache = (_place(cache, mesh, cache_shardings(
                    mesh, cfg, cache, shape.global_batch))
                    if cache is not None else {})
                arg_tensors += list(placed.values()) + list(pcache.values())
                analytic += [(v.shape, batch_spec(mesh, v), v.dtype)
                             for v in (batch or {}).values()]
                analytic += [(v.shape, cache_spec(mesh, cfg, k, v,
                                                  shape.global_batch),
                              v.dtype) for k, v in (cache or {}).items()]
                if shape.kind == "prefill" and cfg.is_encoder_only:
                    def run():
                        with torch.no_grad():
                            h = embed_inputs(cfg, model, placed)
                            pos = torch.arange(h.shape[1], dtype=torch.int32)
                            h, _ = forward_hidden(cfg, model, h,
                                                  positions=pos)
                            h = model.final_norm(h)
                            W = model.embed.table()
                            torch.einsum("bsd,vd->bsv", h, W.to(h.dtype))
                elif shape.kind == "prefill":
                    fn = make_prefill_step(cfg)

                    def run():
                        fn(model, placed, pcache)
                else:
                    tokens = _place({"tokens": specs["tokens"]}, mesh,
                                    batch_shardings(
                                        mesh, {"tokens": specs["tokens"]}))
                    arg_tensors += list(tokens.values())
                    analytic.append((specs["tokens"].shape,
                                     batch_spec(mesh, specs["tokens"]),
                                     torch.int32))
                    fn = make_decode_step(cfg)

                    def run():
                        fn(model, pcache, tokens["tokens"],
                           shape.seq_len - 1)
                update = None
            argument_bytes = _local_bytes(arg_tensors) + acc_bytes
            mt = _mem_tracker()
            mt.track_external(*arg_tensors, *extra_tracked)
            try:
                with mt:
                    start = mt.get_tracker_snapshot("current")
                    got = _measure(run)
                    peak = mt.get_tracker_snapshot("peak")
                if update is not None:
                    upd = _measure(update)
            except Exception:       # the step failed: record it
                result.update(ok=False, error=traceback.format_exc()[-4000:])
                return result
        if update is not None:
            got = _combine(got, upd, n_micro)
        start_b = sum(v["Total"] for v in start.values())
        peak_b = sum(v["Total"] for v in peak.values())
        temp = peak_b - start_b
        mflops = model_flops_per_device(cfg, shape, chips)
        link_total = sum(got["link"].values())
        terms = roofline.roofline_terms(got["flops"], got["hbm_bytes"],
                                        link_total)
        peak_dev = argument_bytes - acc_bytes + temp
        result.update(
            ok=True, seconds=time.perf_counter() - t0, fsdp=fsdp,
            optimizer=("adafactor" if shape.kind == "train" and huge else
                       "adamw" if shape.kind == "train" else None),
            n_micro=n_micro if shape.kind == "train" else None,
            memory={"argument_bytes": argument_bytes,
                    "analytic_argument_bytes": _analytic_bytes(mesh,
                                                               analytic),
                    "grad_accumulator_bytes": acc_bytes,
                    "temp_bytes": temp,
                    "peak_bytes_per_device": peak_dev,
                    "peak_fraction_of_hbm": peak_dev / roofline.HBM_BYTES},
            flops_per_device=got["flops"],
            hbm_bytes_per_device=got["hbm_bytes"],
            collective_counts=got["calls"], collective_bytes=got["bytes"],
            collective_link_bytes=got["link"],
            collective_link_bytes_per_device=link_total,
            all_to_all_native=native_a2a,
            cuda_initialized=torch.cuda.is_initialized(),
            roofline=terms, model_flops_per_device=mflops,
            useful_fraction=(mflops / got["flops"] if got["flops"] else 0.0))
        return result
    finally:
        teardown()


def cell_path(arch: str, shape: str, mesh: str) -> pathlib.Path:
    return ARTIFACT_DIR / f"{arch}_{shape}_{mesh}.json"


def run_all(force: bool = False, timeout_s: int = 3000) -> None:
    """Every cell of every arch at both meshes, a process per cell; a cell
    whose JSON exists is read back unless ``force``."""
    from ..configs import ARCH_IDS, shape_cells, skipped_cells

    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    table = []
    for arch in ARCH_IDS:
        for shape in shape_cells(arch):
            for flag, mesh_name in ((False, "16x16"), (True, "2x16x16")):
                path = cell_path(arch, shape, mesh_name)
                if path.exists() and not force:
                    table.append(json.loads(path.read_text()))
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", str(path)]
                if flag:
                    cmd.append("--multi-pod")
                print(f"[dryrun] {arch} x {shape} x {mesh_name} ...",
                      flush=True)
                t0 = time.time()
                path.unlink(missing_ok=True)
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=timeout_s, env=env)
                if not path.exists():
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "ok": False, "error": r.stderr[-4000:]}
                    path.write_text(json.dumps(rec, indent=2))
                else:
                    rec = json.loads(path.read_text())
                table.append(rec)
                print(f"  {'ok' if rec['ok'] else 'FAILED'} in "
                      f"{time.time() - t0:.0f}s", flush=True)
        for shape, why in skipped_cells(arch).items():
            table.append({"arch": arch, "shape": shape, "mesh": "-",
                          "ok": "skip", "why": why})
    summary = ARTIFACT_DIR / "summary.json"
    summary.write_text(json.dumps(table, indent=2))
    bad = [t for t in table if t["ok"] is False]
    print(f"\n{len(table)} cells recorded; {len(bad)} failures -> {summary}")
    for t in bad:
        print("  FAIL:", t["arch"], t["shape"], t["mesh"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.all:
        run_all(force=args.force)
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    res = run_cell(args.arch, args.shape, args.multi_pod)
    js = json.dumps(res, indent=2)
    print(js)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(js)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
