// K5: beam_gather — row permutation of the decoder's self-attention cache,
// out[l, n] = in[l, src[n]] for the key and the value buffer in one launch.
//
// Replaces the TPU kernel speechmix_tpu/ops/pallas/beam_gather.py:
// beam_gather (_copy_kernel), the self-K/V reorder of every beam-search
// step.
//
// key, value, out_key, out_value: (layers, rows, slab) of any type, viewed as
// bytes: `slab_bytes` per (layer, row), a multiple of 16, buffers 16-byte
// aligned.  src: (rows,) int32 source rows.  The outputs must not overlap the
// inputs: a permutation cannot be done in place.
//
// What bounds it on the H100: bytes, read once and written once (2 x 75 MB
// for the flagship's beam-4 cache).  The grid is (chunks of a slab, rows,
// 2 x layers); a block reads its source row index, then moves its chunk with
// 16-byte loads and stores, neighbouring threads on neighbouring words, four
// words in flight per thread.  The TPU kernel's scalar prefetch, semaphore
// ring and 128-lane view are DMA mechanics of that chip and are not carried
// over.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int UNROLL = 4;
constexpr int CHUNK = NT * UNROLL;  // 16-byte words per block

__global__ void __launch_bounds__(NT)
    beam_gather_kernel(const uint4* __restrict__ key,
                       const uint4* __restrict__ value,
                       const int* __restrict__ src, uint4* __restrict__ out_key,
                       uint4* __restrict__ out_value, int layers, int rows,
                       long long words) {
  const int n = blockIdx.y;
  const int l = blockIdx.z % layers;
  const bool is_value = blockIdx.z >= layers;
  const int s = src[n];
  const uint4* in = (is_value ? value : key) + ((long long)l * rows + s) * words;
  uint4* out = (is_value ? out_value : out_key) + ((long long)l * rows + n) * words;
  const long long w0 = (long long)blockIdx.x * CHUNK + threadIdx.x;
  uint4 buf[UNROLL];
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const long long w = w0 + (long long)i * NT;
    if (w < words) buf[i] = in[w];
  }
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const long long w = w0 + (long long)i * NT;
    if (w < words) out[w] = buf[i];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int smx_beam_gather(const void* key, const void* value,
                               const void* src, void* out_key, void* out_value,
                               int layers, int rows, long long slab_bytes,
                               int device, void* stream) {
  if (layers <= 0 || rows <= 0 || slab_bytes <= 0 || slab_bytes % 16 != 0 ||
      rows > 65535 || 2 * layers > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(key) || !aligned16(value) || !aligned16(out_key) ||
      !aligned16(out_value)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long words = slab_bytes / 16;
  dim3 grid(static_cast<unsigned>((words + CHUNK - 1) / CHUNK), rows,
            2 * layers);
  beam_gather_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(key), static_cast<const uint4*>(value),
      static_cast<const int*>(src), static_cast<uint4*>(out_key),
      static_cast<uint4*>(out_value), layers, rows, words);
  return static_cast<int>(cudaGetLastError());
}
