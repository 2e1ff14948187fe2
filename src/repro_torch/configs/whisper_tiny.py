"""--arch config module; canonical definition in registry.py."""

from .registry import WHISPER_TINY

CONFIG = WHISPER_TINY
