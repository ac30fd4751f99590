"""fleet's layer tier (``mpu``: the tensor-parallel layers)."""
