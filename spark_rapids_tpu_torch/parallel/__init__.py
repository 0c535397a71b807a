"""Multi-chip execution over a mesh of chips (the counterpart of
``spark_rapids_tpu.parallel``).

One process owns every chip of the mesh, as the JAX package's one
process owns ``jax.devices()``: hash exchanges move each row's block
from the chip its batch lives on to the chip that owns its partition
(``ici.py``), batches stay on their chip from the sharded scan to the
exchange, and an exchange can also ship its partitions through SRTB
files in a shared directory (``external_shuffle.py``). A chip is one
CUDA card; ``mesh.emulate_chips`` makes several chips of one device, the
counterpart of XLA's forced host device count.
"""

from spark_rapids_tpu_torch.parallel.mesh import (SHUFFLE_AXIS, Chip,
                                                  TorchMesh, active_mesh,
                                                  build_mesh,
                                                  emulate_chips,
                                                  get_active_mesh,
                                                  set_active_mesh)

__all__ = ["SHUFFLE_AXIS", "Chip", "TorchMesh", "active_mesh",
           "build_mesh", "emulate_chips", "get_active_mesh",
           "set_active_mesh"]
