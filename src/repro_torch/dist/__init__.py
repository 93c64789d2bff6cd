"""``repro_torch.dist``: data parallelism and GPipe on ``torch.distributed``,
the port of the reference's ``repro.dist`` for meshes whose ``model`` axis
is 1.

* :mod:`repro_torch.dist.comm` - every collective the port issues, with the
  bytes it hands to the wire, and mesh axes by name (``bound``);
* :mod:`repro_torch.dist.sharding` - which batch leaves split over the data
  axes;
* :mod:`repro_torch.dist.flow` - data-parallel flow gradients and
  batch-sharded flow serving;
* :mod:`repro_torch.dist.step` - the data-parallel training step (overlapped
  or trailing reduction, or error-feedback compression before the wire);
* :mod:`repro_torch.dist.pipeline` - the GPipe schedule over a ``("pipe",)``
  mesh.

One process per rank; a mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` (``launch/mesh.py``).  The model-sharded half (the parameter,
optimizer and cache rules on DTensor/FSDP placements) is ROADMAP.md queue 1,
item 7 part 2.
"""

from repro_torch.dist import comm, flow, pipeline, sharding, step
from repro_torch.dist.flow import dp_value_and_grad_nll, gather_batch, shard_batch
from repro_torch.dist.pipeline import pipeline_forward, pipeline_stage_fn
from repro_torch.dist.sharding import batch_pspecs, batch_sharding, data_axis_names
from repro_torch.dist.step import dp_axis, dp_size, is_pure_dp, make_dp_train_step

#: the message of everything that waits for the model-sharded meshes
PART_2 = "ROADMAP.md queue 1, item 7 part 2 (model-sharded meshes)"

__all__ = [
    "PART_2",
    "batch_pspecs",
    "batch_sharding",
    "comm",
    "data_axis_names",
    "dp_axis",
    "dp_size",
    "dp_value_and_grad_nll",
    "flow",
    "gather_batch",
    "is_pure_dp",
    "make_dp_train_step",
    "pipeline",
    "pipeline_forward",
    "pipeline_stage_fn",
    "shard_batch",
    "sharding",
    "step",
]
