"""``repro_torch.dist``: data parallelism, model-sharded meshes and GPipe on
``torch.distributed``, the port of the reference's ``repro.dist``.

* :mod:`repro_torch.dist.comm` - every collective the port issues, with the
  bytes it hands to the wire, and mesh axes by name (``bound``), one axis
  or several (a multi-pod mesh's ``("pod", "data")``);
* :mod:`repro_torch.dist.sharding` - the reference's rules: where each
  parameter, optimizer moment, batch and cache leaf lives, and a leaf's
  block on this rank (``local_shard``) and the leaf whole again
  (``gather_shard``);
* :mod:`repro_torch.dist.model` - a module stored as each rank's blocks on
  a mesh whose ``model`` axis is more than 1, or with ``fsdp`` storage or
  ``zero1`` moments, gathered where it is used;
* :mod:`repro_torch.dist.flow` - data-parallel flow gradients and
  batch-sharded flow serving;
* :mod:`repro_torch.dist.step` - the data-parallel training step (overlapped
  or trailing reduction, or error-feedback compression before the wire) and
  the model-sharded step;
* :mod:`repro_torch.dist.pipeline` - the GPipe schedule over the ``pipe``
  axis of a mesh, replicated over its other axes.

One process per rank; a mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` (``launch/mesh.py``).  Parameters are plain local tensors and
every gather is explicit, so the hand-written kernels and the MoE dispatch
see ordinary tensors.  The rules' ``fsdp``, ``zero1`` and per-layer-slice
options are read by the sharded train step, the sequence fallback by
``serve/engine.py``; ``launch/dryrun.py`` reckons the same code on the meta
device through ``comm``'s dry route.
"""

from repro_torch.dist import comm, flow, model, pipeline, sharding, step
from repro_torch.dist.flow import dp_value_and_grad_nll, gather_batch, shard_batch
from repro_torch.dist.pipeline import pipeline_forward, pipeline_stage_fn
from repro_torch.dist.sharding import (
    batch_pspecs,
    batch_sharding,
    cache_pspecs,
    data_axis_names,
    layer_slice_pspecs,
    opt_pspecs,
    params_pspecs,
)
from repro_torch.dist.step import dp_axis, dp_size, is_pure_dp, make_dp_train_step

__all__ = [
    "batch_pspecs",
    "batch_sharding",
    "cache_pspecs",
    "comm",
    "data_axis_names",
    "dp_axis",
    "dp_size",
    "dp_value_and_grad_nll",
    "flow",
    "gather_batch",
    "is_pure_dp",
    "layer_slice_pspecs",
    "make_dp_train_step",
    "model",
    "opt_pspecs",
    "params_pspecs",
    "pipeline",
    "pipeline_forward",
    "pipeline_stage_fn",
    "shard_batch",
    "sharding",
    "step",
]
