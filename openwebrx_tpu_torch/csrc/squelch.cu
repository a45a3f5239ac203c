// Power squelch with hang, the whole of squelch_apply in one launch: per
// row, the mean |x|^2 of each measurement window, its level in dB, the
// compare against the row's threshold, the open/hang recurrence over the
// row's windows and the gated output.
//
// Replaces: openwebrx_tpu/ops/squelch.py squelch_apply (the lax.scan of the
// hang over the windows, with the power, dB and gate around it), which the
// port's plain version runs as about 8 launches plus 6 per window.  Not a
// Pallas kernel: XLA lowers the scan itself.
//
// What bounds it on the card: bytes.  At the NFM bank's shape (1024 rows x
// 2400 complex64 samples, one window a row) it reads x once and writes y
// once, 39.3 MB (11.7 us at 3.35 TB/s), and does ~4 flop a sample.  The
// recurrence is a handful of integer operations a window, and rows have
// one to four windows on the paths.
//
// Design: a CTA owns a few whole rows (about four CTAs per SM; rows longer
// than the tile are walked in tiles of whole windows, and a tile holds at
// least one window) and per tile:
//   1. stages the rows in shared memory with 16-byte cp.async (4-byte when
//      a row is not 16-byte aligned), so x is read from device memory once;
//   2. sums |x|^2 of every window in parallel, a power-of-two group of
//      threads a window (whole warps, combined through shared memory in a
//      fixed order, when there are fewer windows than warps), and turns the
//      mean into 10 log10(max(p, 1e-30)), NaN-propagating as torch.clamp;
//   3. one thread per row runs the hang recurrence over the tile's windows;
//   4. all threads write y = gate ? x : +0.0 from the staged tile with
//      16-byte stores (a select, never x * 0, which would keep -0.0).
// |x|^2 of a complex sample is re^2 + im^2, and +inf where either part is
// infinite, as |x| (a hypot) is.  The window sum is taken in another order
// than torch.mean, so power_db matches the plain version within a stated
// tolerance and the gates wherever the power is not that close to the
// level.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileFloats = 12288;   // staged x per CTA: 48 KB
constexpr int kTargetCtas = 528;     // four per SM of a 132-SM H100
constexpr int kMaxRowsPerCta = 32;   // the recurrence threads fit in warp 0
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* x;          // (rows, n * cplx) floats
  const float* level;      // (rows,) or (1,): level_stride 1 or 0
  const unsigned char* open0;
  const int* hang0;
  float* y;
  float* power_db;         // (rows, n / window)
  unsigned char* open_out;
  int* hang_out;
  int rows, n, window, cplx, level_stride, hang_windows;
  int rows_per_cta;        // rows a CTA owns
  int tile_windows;        // windows per row staged at once
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// a / b for 0 <= a < 2^22: a float estimate corrected by one step
__device__ __forceinline__ int div_small(int a, int b, float inv_b) {
  int q = __float2int_rz(__int2float_rn(a) * inv_b);
  if (q * b > a) --q;
  else if ((q + 1) * b <= a) ++q;
  return q;
}

// torch.clamp_min's NaN-propagating max
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// |x|^2 of one sample: re^2 + im^2, or x^2 for real input
template <int kCplx>
__device__ __forceinline__ float power_of(const float* s) {
  if (kCplx == 1) return __fmul_rn(s[0], s[0]);
  const float re = s[0], im = s[1];
  const float q = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
  return (isinf(re) || isinf(im)) ? __int_as_float(0x7f800000) : q;
}

// kVec: rows staged with 16-byte copies and written with 16-byte stores
// (row and tile starts 16-byte aligned); else 4 bytes at a time.
template <int kCplx, bool kVec>
__global__ void __launch_bounds__(kThreads) squelch_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int wf = p.window * kCplx;        // floats a window
  const int tw = p.tile_windows;
  const int ld = (tw * wf + 3) & ~3;      // row stride of the staged tile
  const int ts = tw | 1;
  const int rpc = p.rows_per_cta;
  const int rowf = p.n * kCplx;           // floats a row
  float* xs = smem;                       // [rpc][ld]
  float* pdb = xs + rpc * ld;             // [rpc][ts] window power, dB
  int* gate = reinterpret_cast<int*>(pdb + rpc * ts);   // [rpc][ts]
  float* part = reinterpret_cast<float*>(gate + rpc * ts);   // [kWarps]
  const int row0 = blockIdx.x * rpc;
  const int nr = min(rpc, p.rows - row0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  bool open = false;
  int h = 0;
  float level = 0.f;
  if (tid < nr) {
    open = p.open0[row0 + tid] != 0;
    h = p.hang0[row0 + tid];
    level = p.level[(row0 + tid) * p.level_stride];
  }

  const int nwin = p.n / p.window;
  const float inv_window = 1.f / (float)p.window;
  for (int c0 = 0; c0 < nwin; c0 += tw) {
    const int tcn = min(tw, nwin - c0);   // windows in this tile
    const int len = tcn * wf;             // floats per row in it
    const float* xg = p.x + (size_t)row0 * rowf + (size_t)c0 * wf;
    float* yg = p.y + (size_t)row0 * rowf + (size_t)c0 * wf;

    // 1. stage the tile: every load in flight at once
    if (kVec) {
      const int q = len >> 2;
      const float inv_q = 1.f / (float)q;
      for (int k = tid; k < nr * q; k += kThreads) {
        const int r = div_small(k, q, inv_q);
        const int i = (k - r * q) << 2;
        cp_async16(xs + r * ld + i, xg + (size_t)r * rowf + i);
      }
    } else {
      const float inv_len = 1.f / (float)len;
      for (int k = tid; k < nr * len; k += kThreads) {
        const int r = div_small(k, len, inv_len);
        const int i = k - r * len;
        cp_async4(xs + r * ld + i, xg + (size_t)r * rowf + i);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. window powers: sub threads a window; more than a warp only when
    // there are fewer windows than warps, and then whole warps
    const int tasks = nr * tcn;
    int sub = 1;
    while (sub < kThreads && tasks * sub * 2 <= kThreads) sub <<= 1;
    const int lsub = __ffs(sub) - 1;
    const int span = (tasks * sub + kThreads - 1) / kThreads * kThreads;
    const float inv_tcn = 1.f / (float)tcn;
    for (int k = tid; k < span; k += kThreads) {   // uniform trip count
      const int task = k >> lsub;
      const int part_i = k & (sub - 1);
      int r = 0, c = 0;
      float s0 = 0.f, s1 = 0.f;
      if (task < tasks) {
        r = div_small(task, tcn, inv_tcn);
        c = task - r * tcn;
        const float* xc = xs + r * ld + c * wf;
        int i = part_i;
#pragma unroll 4
        for (; i + sub < p.window; i += 2 * sub) {
          s0 = __fadd_rn(s0, power_of<kCplx>(xc + i * kCplx));
          s1 = __fadd_rn(s1, power_of<kCplx>(xc + (i + sub) * kCplx));
        }
        if (i < p.window) s0 = __fadd_rn(s0, power_of<kCplx>(xc + i * kCplx));
      }
      float s = __fadd_rn(s0, s1);
      for (int off = min(sub, 32) >> 1; off > 0; off >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
      if (sub > 32) {                       // one task spans sub / 32 warps
        if (lane == 0) part[warp] = s;
        __syncthreads();
        if (part_i == 0 && task < tasks) {
          s = 0.f;
          for (int w = 0; w < (sub >> 5); ++w) s = __fadd_rn(s, part[warp + w]);
        }
        __syncthreads();
      }
      if (task < tasks && part_i == 0) {
        const float mean = __fmul_rn(s, inv_window);
        const float db = __fmul_rn(10.f, log10f(max_nan(mean, 1e-30f)));
        pdb[r * ts + c] = db;
        p.power_db[(size_t)(row0 + r) * nwin + c0 + c] = db;
      }
    }
    __syncthreads();

    // 3. the hang recurrence: one thread per row
    if (tid < nr) {
      for (int c = 0; c < tcn; ++c) {
        const bool above = pdb[tid * ts + c] > level;   // false for NaN
        h = above ? p.hang_windows : max(h - 1, 0);
        open = above || h > 0;
        gate[tid * ts + c] = open;
      }
    }
    __syncthreads();

    // 4. y = gate ? x : +0.0 from the staged tile
    const float inv_wf = 1.f / (float)wf;
    if (kVec) {
      const int q = len >> 2;
      const float inv_q = 1.f / (float)q;
      for (int k = tid; k < nr * q; k += kThreads) {
        const int r = div_small(k, q, inv_q);
        const int i = (k - r * q) << 2;
        float4 v = *reinterpret_cast<const float4*>(xs + r * ld + i);
        const int c = div_small(i, wf, inv_wf);
        if ((i + 3) - c * wf < wf) {        // one window for all four
          if (!gate[r * ts + c]) v = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (!gate[r * ts + div_small(i + u, wf, inv_wf)]) e[u] = 0.f;
          v = make_float4(e[0], e[1], e[2], e[3]);
        }
        *reinterpret_cast<float4*>(yg + (size_t)r * rowf + i) = v;
      }
    } else {
      const float inv_len = 1.f / (float)len;
      for (int k = tid; k < nr * len; k += kThreads) {
        const int r = div_small(k, len, inv_len);
        const int i = k - r * len;
        const int c = div_small(i, wf, inv_wf);
        yg[(size_t)r * rowf + i] = gate[r * ts + c] ? xs[r * ld + i] : 0.f;
      }
    }
    __syncthreads();   // the next tile overwrites xs, pdb and gate
  }
  if (tid < nr) {
    p.open_out[row0 + tid] = open ? 1 : 0;
    p.hang_out[row0 + tid] = h;
  }
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

template <int kCplx>
cudaError_t launch(Params p, bool vec, size_t smem, cudaStream_t stream) {
  auto kernel = vec ? squelch_kernel<kCplx, true> : squelch_kernel<kCplx, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (p.rows + p.rows_per_cta - 1) / p.rows_per_cta;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, n) complex64 (cplx 2) or float32 (cplx 1), n a multiple of
// window; level: (rows,) float32, or one value for every row
// (level_per_row 0); open0, open_out: (rows,) bool as bytes; hang0,
// hang_out: (rows,) int32; power_db: (rows, n / window) float32.  All
// contiguous.
extern "C" int squelch_launch(const void* x, const void* level,
                              const void* open0, const void* hang0, void* y,
                              void* power_db, void* open_out, void* hang_out,
                              int rows, int n, int window, int cplx,
                              int level_per_row, int hang_windows,
                              void* stream) {
  if (rows <= 0 || window <= 0 || n <= 0 || n % window != 0 ||
      (cplx != 1 && cplx != 2))
    return (int)cudaErrorInvalidValue;
  const int nwin = n / window;
  const int wf = window * cplx;
  const int rowf = n * cplx;
  bool vec = rowf % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int row_pad = (rowf + 3) & ~3;
  int rpc = (rows + kTargetCtas - 1) / kTargetCtas;
  rpc = std::min(std::min(rpc, kMaxRowsPerCta), std::max(1, kTileFloats / row_pad));
  int tw = nwin;
  if (row_pad > kTileFloats) {   // rpc == 1: walk the row in tiles
    tw = std::max(1, kTileFloats / wf);
    if (vec) {
      const int m = 4 / gcd(wf, 4);   // 16-byte aligned tile starts
      if (tw >= m) tw -= tw % m;
      else vec = false;
    }
  }
  const int ld = (tw * wf + 3) & ~3;
  const size_t smem = sizeof(float) *
      ((size_t)rpc * (ld + 2 * (tw | 1)) + kWarps);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  Params p{static_cast<const float*>(x), static_cast<const float*>(level),
           static_cast<const unsigned char*>(open0),
           static_cast<const int*>(hang0), static_cast<float*>(y),
           static_cast<float*>(power_db),
           static_cast<unsigned char*>(open_out), static_cast<int*>(hang_out),
           rows, n, window, cplx, level_per_row ? 1 : 0, hang_windows, rpc, tw};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cplx == 2 ? launch<2>(p, vec, smem, s) : launch<1>(p, vec, smem, s);
  return (int)e;
}

extern "C" const char* owrx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
