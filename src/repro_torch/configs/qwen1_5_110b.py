"""--arch config module; canonical definition in registry.py."""

from .registry import QWEN15_110B

CONFIG = QWEN15_110B
