from seedvc_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES,
    AxisNames,
    Mesh,
    current_mesh,
    make_mesh,
    replicate,
    set_mesh,
    shard_batch,
)
from seedvc_tpu_torch.parallel.sharding import (  # noqa: F401
    dit_param_sharding,
    logical_to_sharding,
)
