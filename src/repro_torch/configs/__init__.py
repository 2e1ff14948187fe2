"""Architecture & shape configs: one module-level entry per assigned arch
(see registry.py), the reduced smoke variants, and the paper's own dense
linear algebra problem configs (paper_problems.py)."""

from .base import (EncoderConfig, ModelConfig, MoEConfig, SHAPES, ShapeConfig,
                   SSMConfig, VisionConfig)
from .registry import ALL_CELLS, ARCHS, cells, get
