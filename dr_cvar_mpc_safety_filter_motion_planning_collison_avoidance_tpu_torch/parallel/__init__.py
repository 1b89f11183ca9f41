from . import mesh
from . import distributed
from . import sample_parallel
from . import sweep
from .distributed import (initialize_distributed, make_multihost_mesh,
                          multihost_grid)
from .mesh import (CENSUS, Mesh, gather_batch, make_mesh, replicated,
                   shard_batch)
from .sample_parallel import dr_cvar_g_sample_parallel
from .sweep import (make_sharded_timing_solvers, run_batch_sharded,
                    sharded_halfspace_throughput)
