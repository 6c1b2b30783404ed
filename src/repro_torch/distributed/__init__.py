"""Sharding for the production meshes as DTensor placements (the
counterpart of ``repro.distributed``)."""
from .hints import BATCH, hint, replicate_like, set_mesh
from .sharding import (activation_spec, batch_axes, batch_shardings,
                       batch_spec, cache_shardings, cache_spec, data_size,
                       distribute_batch, distribute_model, local_shape,
                       param_shardings, param_spec, param_specs, replicated,
                       to_placements)

__all__ = ["BATCH", "activation_spec", "batch_axes", "batch_shardings",
           "batch_spec", "cache_shardings", "cache_spec", "data_size",
           "distribute_batch", "distribute_model", "hint", "local_shape",
           "param_shardings", "param_spec", "param_specs", "replicate_like",
           "replicated", "set_mesh", "to_placements"]
