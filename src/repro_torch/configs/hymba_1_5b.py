"""--arch config module; canonical definition in registry.py."""

from .registry import HYMBA_15B

CONFIG = HYMBA_15B
