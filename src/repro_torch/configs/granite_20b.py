"""--arch config module; canonical definition in registry.py."""

from .registry import GRANITE_20B

CONFIG = GRANITE_20B
