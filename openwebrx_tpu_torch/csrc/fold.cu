// Polyphase fold of the PFB channelizer: v[t, p] = sum_{j<P} u[t+j, p] * B[j, p].
//
// Replaces: openwebrx_tpu/ops/pallas_fold.py, _fold_kernel (called through
// polyphase_fold), the TPU kernel that DMAs a (256+24, M) window of split
// re/im planes into VMEM per grid step and unrolls the P taps on the VPU.
// The JAX product path computes the same sum as a depthwise XLA conv
// (ops/channelizer.py channelize); the port's channelize calls this kernel.
//
// What bounds it on the card: bytes.  Each output costs 2*P fused
// multiply-adds and 8 bytes out for 8 bytes in (plus the P*M bank, read
// once), so at M=1024, P=16 and 2400 output rows (one 50 ms block at
// 49.152 MS/s) it moves about 39.4 MB: ~11.8 us at 3.35 TB/s, against
// ~0.08 GFLOP that the card does in ~1.2 us.
//
// Design: complex64 stays interleaved (float2 loads, no split planes).
// One thread per phase lane p, consecutive threads on consecutive lanes, so
// every row load of a warp is one contiguous 256-byte segment.  A CTA covers
// 128 lanes x T_TILE output rows.  Each thread keeps its lane's P taps and a
// sliding window of the last P input rows in registers, so inside a tile
// each u element is loaded from memory once; neighbouring tiles re-read only
// their P-1 halo rows, which sit in L2.  P is a template parameter
// (1..25, the range the TPU kernel allows) so the window and the tap array
// stay in registers.  Accumulation is fp32.  Ragged edges in M and in time
// are masked.  Simple first: no shared memory, no TMA.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;   // threads per CTA, one PFB phase lane each
constexpr int kTile = 32;     // output rows per CTA

template <int P>
__global__ void __launch_bounds__(kLanes)
fold_kernel(const float2* __restrict__ u, const float* __restrict__ bank,
            float2* __restrict__ v, int m, int n_out) {
  const int p = blockIdx.y * kLanes + threadIdx.x;
  if (p >= m) return;
  const int t0 = blockIdx.x * kTile;
  const int t_end = min(t0 + kTile, n_out);

  float b[P];
#pragma unroll
  for (int j = 0; j < P; ++j) b[j] = __ldg(bank + (size_t)j * m + p);

  float2 w[P];
#pragma unroll
  for (int j = 0; j < P - 1; ++j) w[j] = __ldg(u + (size_t)(t0 + j) * m + p);

#pragma unroll 4
  for (int t = t0; t < t_end; ++t) {
    w[P - 1] = __ldg(u + (size_t)(t + P - 1) * m + p);
    float re = 0.f, im = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      re = fmaf(w[j].x, b[j], re);
      im = fmaf(w[j].y, b[j], im);
    }
    v[(size_t)t * m + p] = make_float2(re, im);
#pragma unroll
    for (int j = 0; j < P - 1; ++j) w[j] = w[j + 1];
  }
}

}  // namespace

extern "C" int fold_launch(const void* u, const void* bank, void* v,
                           int n_time, int m, int p_taps, void* stream) {
  const int n_out = n_time - p_taps + 1;
  if (m <= 0 || n_out <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_out + kTile - 1) / kTile, (m + kLanes - 1) / kLanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* uu = static_cast<const float2*>(u);
  const float* bb = static_cast<const float*>(bank);
  float2* vv = static_cast<float2*>(v);
  switch (p_taps) {
#define OWRX_FOLD_CASE(P) \
    case P: fold_kernel<P><<<grid, kLanes, 0, s>>>(uu, bb, vv, m, n_out); break;
    OWRX_FOLD_CASE(1) OWRX_FOLD_CASE(2) OWRX_FOLD_CASE(3) OWRX_FOLD_CASE(4)
    OWRX_FOLD_CASE(5) OWRX_FOLD_CASE(6) OWRX_FOLD_CASE(7) OWRX_FOLD_CASE(8)
    OWRX_FOLD_CASE(9) OWRX_FOLD_CASE(10) OWRX_FOLD_CASE(11) OWRX_FOLD_CASE(12)
    OWRX_FOLD_CASE(13) OWRX_FOLD_CASE(14) OWRX_FOLD_CASE(15) OWRX_FOLD_CASE(16)
    OWRX_FOLD_CASE(17) OWRX_FOLD_CASE(18) OWRX_FOLD_CASE(19) OWRX_FOLD_CASE(20)
    OWRX_FOLD_CASE(21) OWRX_FOLD_CASE(22) OWRX_FOLD_CASE(23) OWRX_FOLD_CASE(24)
    OWRX_FOLD_CASE(25)
#undef OWRX_FOLD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* owrx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
