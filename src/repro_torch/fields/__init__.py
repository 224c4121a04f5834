"""Synthetic scalar fields (numpy)."""
