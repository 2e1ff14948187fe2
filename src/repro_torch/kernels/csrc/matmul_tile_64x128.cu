// K1's fp32 body at the 64 x 128 CTA tile (matmul_f32.cuh), compiled
// on its own so that the build compiles the tiles in parallel.
#include "matmul_f32.cuh"

REPRO_K1_TILE(Tile64x128)
