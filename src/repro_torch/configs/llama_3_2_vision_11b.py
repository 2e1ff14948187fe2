"""--arch config module; canonical definition in registry.py."""

from .registry import LLAMA32_VISION_11B

CONFIG = LLAMA32_VISION_11B
