from raymarchrenderer.parallel.sharding import (  # noqa: F401
    make_mesh, render_sharded, train_step_sharded, ShardConfig, auto_shard,
    gather_image,
)
from raymarchrenderer.parallel import multihost  # noqa: F401
from raymarchrenderer.parallel.recovery import (  # noqa: F401
    ElasticResult, ShardFailure, render_elastic, oracle_shard_fn,
    fused_shard_fn,
)
