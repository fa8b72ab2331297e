"""Multi-device parallelism: the device mesh, sharded inference and
triangulation, batched calibration, and the multi-recording fleet driver.

Counterpart of ``deepfly3d_tpu/parallel/``.  One process drives every
device, as in JAX: recordings x cameras x frames split over a
``mesh.Mesh`` of ``torch.device`` entries, each entry running its shard
with no collective.
"""

from deepfly3d_torch.parallel.mesh import data_mesh, replicate, shard_batch

__all__ = ["data_mesh", "shard_batch", "replicate"]
