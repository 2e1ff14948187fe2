// K4's fp32 body (flash_attention_f32.cu), for the launcher in
// flash_attention.cu.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace repro_k4 {

// K4 on fp32 operands (repro_flash_attention's arguments) at the tile
// f32_tile picks, which *body reports (kernels.h: REPRO_K4_F32_*). Returns
// cudaErrorMisalignedAddress, launching nothing, unless q, k, v and o are
// 16-byte aligned with (batch, head, row) strides in multiples of 4 floats,
// and cudaErrorInvalidDevice if the device's SMs cannot be read.
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int batch, int heads, int kv_heads, int sq, int skv,
                       int d, const long long* st, float scale, int causal,
                       int* body, cudaStream_t stream);

// The tile (REPRO_K4_F32_*) of the fp32 body at d for batch * heads
// (batch, head) pairs of sq query rows on the current device.
int f32_tile(int d, int batch, int heads, int sq);

// The shared memory of a CTA of the fp32 body at d above 256, in bytes.
size_t f32_bytes(int d);

}  // namespace repro_k4
