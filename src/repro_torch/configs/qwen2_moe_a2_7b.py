"""--arch config module; canonical definition in registry.py."""

from .registry import QWEN2_MOE_A27B

CONFIG = QWEN2_MOE_A27B
