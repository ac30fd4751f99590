"""fleet's meta-parallel tier: ``TensorParallel``, the pipeline and group
sharding. Context parallelism (ring / ulysses) is ROADMAP A7's
remainder."""
from ..layers.mpu.mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding,
)
from . import sharding  # noqa: F401
from .meta_parallel_base import MetaParallelBase, TensorParallel  # noqa: F401
from .parallel_layers.pp_layers import (  # noqa: F401
    LayerDesc, PipelineLayer, SharedLayerDesc,
)
from .pipeline_parallel import (  # noqa: F401
    PipelineParallel, PipelineParallelWithInterleave,
)
