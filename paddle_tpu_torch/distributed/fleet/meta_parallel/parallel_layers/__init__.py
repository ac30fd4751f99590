"""The pipeline's layer descriptions (``pp_layers.py``)."""
