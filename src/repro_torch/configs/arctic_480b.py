"""--arch config module; canonical definition in registry.py."""

from .registry import ARCTIC_480B

CONFIG = ARCTIC_480B
