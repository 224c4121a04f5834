from .registry import ARCHS, get_config, smoke_config  # noqa: F401
