"""The port's counterpart of ``paddle_tpu/core``: dtypes, places, seeds,
flags, ``to_tensor`` / ``Parameter``, grad modes and the op registry, all
mapped onto torch (the tensor is ``torch.Tensor``, autograd is torch's)."""
