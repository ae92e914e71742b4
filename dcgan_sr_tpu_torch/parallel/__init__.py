from .mesh import (Mesh, create_mesh, device_count, initialize_distributed,  # noqa: F401
                   initialize_from_env, launched, local_batch_slice)
from .collectives import (all_gather, axis_index, axis_size, pmean,  # noqa: F401
                          ppermute, psum, reduce_scatter)
from .dp import (build_dp_multi_step, build_dp_train_step,  # noqa: F401
                 replicate_state, shard_batch)
