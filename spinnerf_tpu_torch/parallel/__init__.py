"""Data parallelism across processes, one rank each (`mesh.py`), and the
1-rank against N-rank check of the three data-parallel paths
(`dryrun.py`)."""
from spinnerf_tpu_torch.parallel.mesh import (Mesh, current, for_config,
                                              join, launch, leave)

__all__ = ["Mesh", "current", "for_config", "join", "launch", "leave"]
