// Stride-parallel IMA ADPCM encode: one thread per (channel, stride) lane.
//
// Replaces: the lax.scan at the core of openwebrx_tpu/ops/adpcm.py
// adpcm_encode (the STATE_STRIDE-step scan over _encode_nibble pairs).  Each
// lane starts from its reseed state (predictor = raw sample before the
// stride, step index estimated from the stride before it; both computed by
// the caller exactly as the reference does) and runs 100 pair-steps, i.e.
// 200 dependent nibble steps, writing the stride's 100 bytes.  The output
// bytes must equal the reference bit for bit: the browser decoder adopts the
// reseed states carried in the sync headers.
//
// What bounds it on the card: neither bytes nor operations.  At the
// 1024-channel bank's shape (1024 x 600 int16 in, 1024 x 300 bytes out,
// 3072 lanes) it moves ~1.6 MB (~0.5 us at 3.35 TB/s) and does ~15 M
// integer operations (~0.2 us).  What it cannot escape is the serial
// dependence: each nibble step is a chain of ~25 dependent integer
// operations through predictor and index, 200 steps per lane, so one lane
// takes ~5000 dependent instructions however many lanes run beside it
// (~4 cycles each: ~11 us at 1.75 GHz).  3072 lanes are fewer than one warp
// per SM scheduler, so nothing hides that latency.
//
// Design: lanes are spread thinly (32 threads per CTA, 96 CTAs for 3072
// lanes) so every warp has an SM scheduler to itself.  The step table lives
// in __constant__ memory and is staged into shared memory at CTA start:
// lanes index it divergently, and divergent constant reads serialise while
// shared-memory reads cost at worst a bank conflict.  The index table is
// closed-form arithmetic on the nibble (as in the reference).  Samples are
// read as int32 words holding one sample pair; bytes are written as one
// uint32 word per four pair-steps.

#include <cuda_runtime.h>

namespace {

constexpr int kStride = 100;       // bytes per stride (STATE_STRIDE)
constexpr int kThreads = 32;

__constant__ int kStepTable[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17,
    19, 21, 23, 25, 28, 31, 34, 37, 41, 45,
    50, 55, 60, 66, 73, 80, 88, 97, 107, 118,
    130, 143, 157, 173, 190, 209, 230, 253, 279, 307,
    337, 371, 408, 449, 494, 544, 598, 658, 724, 796,
    876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358,
    5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

__device__ __forceinline__ int encode_nibble(int& predictor, int& index,
                                             int sample, const int* table) {
  const int step = table[index];
  int diff = sample - predictor;
  const int sign = diff < 0 ? 1 : 0;
  diff = abs(diff);
  int nib = 0;
  int delta = step >> 3;
  if (diff >= step) { nib |= 4; diff -= step; delta += step; }
  const int step2 = step >> 1;
  if (diff >= step2) { nib |= 2; diff -= step2; delta += step2; }
  const int step4 = step >> 2;
  if (diff >= step4) { nib |= 1; delta += step4; }
  if (sign) delta = -delta;
  predictor = min(max(predictor + delta, -32768), 32767);
  nib |= sign << 3;
  const int low = nib & 7;
  index = min(max(index + (low < 4 ? -1 : 2 * low - 6), 0), 88);
  return nib;
}

__global__ void __launch_bounds__(kThreads)
adpcm_kernel(const int* __restrict__ pairs, const int* __restrict__ prev,
             const int* __restrict__ idxs, unsigned int* __restrict__ out,
             int lanes) {
  __shared__ int table[89];
  for (int i = threadIdx.x; i < 89; i += blockDim.x) table[i] = kStepTable[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  int predictor = prev[lane];
  int index = idxs[lane];
  const int* src = pairs + (size_t)lane * kStride;
  unsigned int* dst = out + (size_t)lane * (kStride / 4);
  for (int w = 0; w < kStride / 4; ++w) {
    unsigned int word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pair = __ldg(src + 4 * w + k);
      const int first = (int)(short)(pair & 0xFFFF);   // little-endian pair
      const int second = pair >> 16;                    // arithmetic shift
      const int lo = encode_nibble(predictor, index, first, table);
      const int hi = encode_nibble(predictor, index, second, table);
      word |= (unsigned int)(lo | (hi << 4)) << (8 * k);
    }
    dst[w] = word;
  }
}

}  // namespace

// samples: (lanes, 2*kStride) int16; prev, idxs: (lanes,) int32;
// out: (lanes, kStride) uint8.  All contiguous and 4-byte aligned.
extern "C" int adpcm_launch(const void* samples, const void* prev,
                            const void* idxs, void* out, int lanes,
                            void* stream) {
  if (lanes <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (lanes + kThreads - 1) / kThreads;
  adpcm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(samples), static_cast<const int*>(prev),
      static_cast<const int*>(idxs), static_cast<unsigned int*>(out), lanes);
  return (int)cudaGetLastError();
}

extern "C" const char* owrx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
