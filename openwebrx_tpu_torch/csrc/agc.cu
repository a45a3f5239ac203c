// Chunked AGC, the whole of agc_apply in one launch: per row, the peak
// |x| of each chunk, the attack/decay/hang gain recurrence over the chunks,
// and the hold-with-ramp gain interpolation multiplied into the samples.
//
// Replaces: the lax.scan of openwebrx_tpu/ops/agc.py (agc_apply, the step
// over chunk peaks) with the reductions and the ramp around it, which the
// port's plain version runs as a Python loop of ~10 small launches per
// chunk.  Not a Pallas kernel: XLA lowers the scan itself.
//
// What bounds it on the card: neither bytes nor operations but the serial
// chain.  At the NFM bank's shape (1024 rows x 2400 samples, 48 chunks of
// 50) it moves 19.7 MB (~5.9 us at 3.35 TB/s) and does ~10 MFLOP; each
// chunk step is a warp max-reduction (5 shuffles) followed by a dependent
// divide, compare and clamp, ~48 x ~150 cycles per row, ~4 us at 1.75 GHz,
// and every row runs beside the others.
//
// Design: one warp per row.  Per chunk the lanes stride over the chunk's
// samples for the peak (coalesced), reduce it with xor-shuffles so every
// lane holds it, and every lane runs the same recurrence step, so the gain
// needs no broadcast.  The lanes then read the chunk again (from L1) and
// write x * gain ramp.  The arithmetic repeats the plain version's float32
// operations in its order with round-to-nearest intrinsics (no contraction
// into fused multiply-adds), so the final gain and hang counter equal the
// plain version's bit for bit and the audio too: the ramp is i / chunk
// divided in float32, as the plain version's host-made ramp is.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;          // rows per CTA, one warp each
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarps)
agc_kernel(const float* __restrict__ x, const float* __restrict__ gain0,
           const int* __restrict__ hang0, float* __restrict__ y,
           float* __restrict__ gain_out, int* __restrict__ hang_out,
           int rows, int n, int chunk, float attack, float decay,
           int hang_chunks, float reference, float max_gain) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;           // uniform across the warp
  const int nchunks = n / chunk;
  const float* xr = x + (size_t)row * n;
  float* yr = y + (size_t)row * n;
  const float fchunk = (float)chunk;
  float g = gain0[row];
  int h = hang0[row];

  for (int c = 0; c < nchunks; ++c) {
    const float* xs = xr + (size_t)c * chunk;
    float peak = 0.f;                // |x| >= 0: 0 is the max's identity
    for (int i = lane; i < chunk; i += 32) peak = fmaxf(peak, fabsf(__ldg(xs + i)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      peak = fmaxf(peak, __shfl_xor_sync(kFull, peak, off));

    // one recurrence step, the same on every lane
    const float env = peak < 1e-9f ? 1e-9f : peak;
    const float target = __fdiv_rn(reference, env);
    const bool attacking = target < g;
    const float d = __fsub_rn(target, g);
    const float g_att = __fadd_rn(g, __fmul_rn(attack, d));
    const float g_dec = __fadd_rn(g, __fmul_rn(decay, d));
    const int h_new = attacking ? hang_chunks : max(h - 1, 0);
    float g_new = attacking ? g_att : (h > 0 ? g : g_dec);
    g_new = g_new < 1e-6f ? 1e-6f : (g_new > max_gain ? max_gain : g_new);

    // hold-with-ramp from the previous chunk's gain
    const float step = __fsub_rn(g_new, g);
    float* ys = yr + (size_t)c * chunk;
    for (int i = lane; i < chunk; i += 32) {
      const float ramp = __fdiv_rn((float)i, fchunk);
      const float gs = __fadd_rn(g, __fmul_rn(step, ramp));
      ys[i] = __fmul_rn(__ldg(xs + i), gs);
    }
    g = g_new;
    h = h_new;
  }
  if (lane == 0) {
    gain_out[row] = g;
    hang_out[row] = h;
  }
}

}  // namespace

// x, y: (rows, n) float32, n a multiple of chunk; gain0, gain_out: (rows,)
// float32; hang0, hang_out: (rows,) int32.  All contiguous.
extern "C" int agc_launch(const void* x, const void* gain0, const void* hang0,
                          void* y, void* gain_out, void* hang_out, int rows,
                          int n, int chunk, float attack, float decay,
                          int hang_chunks, float reference, float max_gain,
                          void* stream) {
  if (rows <= 0 || chunk <= 0 || n <= 0 || n % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kWarps - 1) / kWarps;
  agc_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gain0),
      static_cast<const int*>(hang0), static_cast<float*>(y),
      static_cast<float*>(gain_out), static_cast<int*>(hang_out), rows, n,
      chunk, attack, decay, hang_chunks, reference, max_gain);
  return (int)cudaGetLastError();
}

extern "C" const char* owrx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
