"""``python -m paddle_tpu_torch.obs``: the reference's ``obs`` command line
comes with the second half of the host tiers."""
from .._later import not_ported

not_ported("the obs command line", "A5, second half")()
