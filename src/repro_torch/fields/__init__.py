"""Synthetic scalar fields (numpy)."""
from .generators import FIELDS, make_field, make_field_chunk  # noqa: F401
