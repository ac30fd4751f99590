"""Communication groups of the port (``group.py``)."""
from .group import Group, get_group, is_initialized, new_group  # noqa: F401
