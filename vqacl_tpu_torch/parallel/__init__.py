from vqacl_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshContext,
    make_mesh,
    shard_batch,
    replicate,
)
from vqacl_tpu_torch.parallel.sharding import (  # noqa: F401
    param_sharding_rules,
    apply_rules,
)
