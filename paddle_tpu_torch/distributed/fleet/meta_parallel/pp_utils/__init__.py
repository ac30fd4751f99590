"""Pipeline helpers (``utils.py``)."""
