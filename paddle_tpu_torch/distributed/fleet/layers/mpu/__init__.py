from . import mp_ops  # noqa: F401
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding,
)
from .....core.random import get_rng_state_tracker  # noqa: F401
