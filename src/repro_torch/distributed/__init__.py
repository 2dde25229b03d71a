"""The port's mesh and collective layer over ``torch.distributed``: the
counterpart of the JAX package's ``launch/mesh.py`` and
``distributed/compat.py`` (see ``mesh.py``)."""
from repro_torch.distributed.mesh import (Mesh, init_world, make_debug_mesh,
                                          make_mesh, spawn_world)

__all__ = ["Mesh", "init_world", "make_debug_mesh", "make_mesh",
           "spawn_world"]
