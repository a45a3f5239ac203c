// First-order IIR section, streamed over rows of contiguous samples:
//   c[n] = b0*x[n] + b1*x[n-1]   (x[-1] = x_prev)
//   y[n] = a1*y[n-1] + c[n]      (y[-1] = y_prev)
// and the new state (x[B-1], y[B-1]) of each row.
//
// Replaces: the jax.lax.associative_scan of openwebrx_tpu/ops/iir.py
// (linear_recurrence, reached through first_order_apply), the DC blocker of
// AM/SAM and the de-emphasis of NFM/WFM.  Not a Pallas kernel: XLA lowers
// the scan itself.
//
// What bounds it on the card: bytes.  Per sample it reads 4 bytes, writes 4
// and does ~4 flops, so at the 1024-channel NFM bank's shape (1024 x 2400)
// it moves 19.7 MB, ~5.9 us at 3.35 TB/s, against ~10 MFLOP.  What stands
// in the way is the serial dependence along each row: one thread per row
// would walk 2400 dependent steps with loads 9.6 KB apart that never
// coalesce.
//
// Design: one warp per row, walking the row in tiles of 256 samples.  A
// tile is loaded coalesced into shared memory (each lane's 8-sample segment
// padded to 9 words, so the segment reads are free of bank conflicts).
// Each lane forms its 8 values c[n], composes its segment's affine map
// y -> A*y + Y, and the warp scans those maps with shuffles (5 steps).
// Each lane then re-runs its 8 steps sequentially from its carry-in, so
// within a segment the order is the sequential one; the outputs go back
// through shared memory and out coalesced.  The tile's last y and x carry
// to the next tile.  c[n] is formed with round-to-nearest intrinsics in the
// plain version's order; the scan order differs from both the plain
// doubling scan and the TPU's tree, so results agree within a tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;            // rows per CTA, one warp each
constexpr int kPer = 8;              // samples per lane per tile
constexpr int kTile = 32 * kPer;     // samples per tile
constexpr int kPad = kPer + 1;       // padded segment stride in shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int slot(int j) {
  return (j / kPer) * kPad + (j % kPer);
}

__global__ void __launch_bounds__(32 * kWarps)
iir_kernel(const float* __restrict__ x, const float* __restrict__ x_prev,
           const float* __restrict__ y_prev, float* __restrict__ y,
           float* __restrict__ x_last, float* __restrict__ y_last, int rows,
           int n, float b0, float b1, float a1) {
  __shared__ float buf[kWarps][32 * kPad];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;             // uniform across the warp
  float* sb = buf[warp];
  const float* xr = x + (size_t)row * n;
  float* yr = y + (size_t)row * n;
  float xc = x_prev[row];              // x before the tile
  float yc = y_prev[row];              // y before the tile
  const int j0 = lane * kPer;          // this lane's segment in the tile

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int v = min(kTile, n - t0);  // valid samples in this tile
    for (int j = lane; j < v; j += 32) sb[slot(j)] = __ldg(xr + t0 + j);
    __syncwarp();
    const int cnt = max(0, min(kPer, v - j0));
    float c[kPer];
    float xb = (j0 == 0) ? xc : (cnt > 0 ? sb[slot(j0 - 1)] : 0.f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float xi = (i < cnt) ? sb[slot(j0 + i)] : 0.f;
      c[i] = __fadd_rn(__fmul_rn(b0, xi), __fmul_rn(b1, xb));
      xb = xi;
    }
    const float x_tile_last = sb[slot(v - 1)];

    // this segment's map y -> A*y + Y, then an inclusive warp scan
    float a = 1.f, yy = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i < cnt) {
        yy = fmaf(a1, yy, c[i]);
        a *= a1;
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float ap = __shfl_up_sync(kFull, a, off);
      const float yp = __shfl_up_sync(kFull, yy, off);
      if (lane >= off) {
        yy = fmaf(a, yp, yy);
        a *= ap;
      }
    }
    // carry-in: the lanes before this one applied to the tile's carry
    const float ae = __shfl_up_sync(kFull, a, 1);
    const float ye = __shfl_up_sync(kFull, yy, 1);
    float yv = (lane == 0) ? yc : fmaf(ae, yc, ye);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i < cnt) {
        yv = fmaf(a1, yv, c[i]);
        c[i] = yv;
      }
    }
    __syncwarp();                      // every lane has read its x
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (i < cnt) sb[slot(j0 + i)] = c[i];
    __syncwarp();
    for (int j = lane; j < v; j += 32) yr[t0 + j] = sb[slot(j)];
    xc = x_tile_last;
    yc = sb[slot(v - 1)];
    __syncwarp();                      // before the next tile overwrites
  }
  if (lane == 0) {
    x_last[row] = xc;
    y_last[row] = yc;
  }
}

}  // namespace

// x, y: (rows, n) float32; x_prev, y_prev, x_last, y_last: (rows,) float32.
// All contiguous.
extern "C" int iir_launch(const void* x, const void* x_prev,
                          const void* y_prev, void* y, void* x_last,
                          void* y_last, int rows, int n, float b0, float b1,
                          float a1, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kWarps - 1) / kWarps;
  iir_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(x_prev),
      static_cast<const float*>(y_prev), static_cast<float*>(y),
      static_cast<float*>(x_last), static_cast<float*>(y_last), rows, n, b0,
      b1, a1);
  return (int)cudaGetLastError();
}

extern "C" const char* owrx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
