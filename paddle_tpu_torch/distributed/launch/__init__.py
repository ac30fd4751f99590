"""``python -m paddle_tpu_torch.distributed.launch`` (``main.py``)."""
