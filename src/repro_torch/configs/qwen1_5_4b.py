"""--arch config module; canonical definition in registry.py."""

from .registry import QWEN15_4B

CONFIG = QWEN15_4B
