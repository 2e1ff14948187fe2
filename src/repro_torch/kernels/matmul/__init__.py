from .ops import (CTA_TILES, DEFAULT_CTA_TILE, cta_tile, matmul,
                  matmul_cuda)
from .ref import matmul_ref
