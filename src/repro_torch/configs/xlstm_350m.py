"""--arch config module; canonical definition in registry.py."""

from .registry import XLSTM_350M

CONFIG = XLSTM_350M
