"""--arch config module; canonical definition in registry.py."""

from .registry import STARCODER2_3B

CONFIG = STARCODER2_3B
