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
// and does ~5 flops, so at the 1024-channel NFM bank's shape (1024 x 2400)
// it moves 19.7 MB, ~5.9 us at 3.35 TB/s, against ~12 MFLOP.  To reach that
// the card needs tens of KB in flight on every SM at once; the serial
// dependence along a row must not decide when a byte is loaded.  (The first
// port walked each row with one warp in 256-sample tiles, one after
// another: ~8 KB in flight an SM, latency-bound at a third of the bound.)
//
// Design: a piece of the flat (rows, n) array is staged whole in shared
// memory with one burst of cp.async (16-byte vectors, 4-byte copies at the
// unaligned ends), so every byte of it is in flight together; then each
// thread composes the affine map y -> A*y + Y of a run of consecutive
// samples (c[n] in the plain version's order, __fmul_rn/__fadd_rn), a scan
// of the maps gives every run its carry-in, and the run is replayed from it
// in place and stored with coalesced 16-byte stores.  Two shapes of work:
//   - Short rows (n <= 1024, the AM bank's 600): one warp a row, each lane
//     a run of ceil(n / 32) samples made odd (so the runs' shared-memory
//     reads miss no bank) and held in registers, a warp scan.  No
//     block-wide barrier: every warp loads, scans and stores on its own,
//     so rows overlap each other's phases.
//   - Long rows: a CTA takes whole rows (the NFM bank's 2400 samples: one
//     row, 160 threads of 15) or, when rows are few, a chunk of a row cut
//     into up to 8, one CTA each, launched as one thread-block cluster whose
//     CTAs exchange their chunk's map through distributed shared memory, so
//     the carries cross CTAs without a second launch (config #1's single
//     row of 4800 samples runs on 8 SMs, the WFM bank's 128 rows of 9600 on
//     five each).  Runs of 15 samples, a CTA-wide scan (warp shuffles, then
//     across warps through shared memory); a row start inside a run resets
//     its map to the row's carried state.  The launch aims at 4 CTAs an SM.
// The scan order differs from both the plain doubling scan and the TPU's
// tree, so results agree within a tolerance; x_last is a copy, bit-exact.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPer = 15;             // samples a thread: odd, so the runs'
                                     // shared-memory reads miss no bank
constexpr int kMaxChunk = kPer * kMaxThreads;   // samples a CTA stages
constexpr int kMinChunk = 512;       // a row is not cut finer than this
constexpr int kMaxParts = 8;         // CTAs a row: a portable cluster
constexpr int kShortRow = 1024;      // rows up to this long: a warp each
constexpr int kMaxRun = ((kShortRow + 31) / 32) | 1;   // samples a lane there
constexpr int kRowWarps = 1;         // rows a CTA on that path (one warp
                                     // each: more were slower at AM's shape)
// whole rows a CTA of the long-row path: longer than kShortRow, so few
constexpr int kMaxRowsPerCta = kMaxChunk / (kShortRow + 1);
constexpr int kCtasPerSm = 4;        // long rows: CTAs an SM the launch aims at
constexpr unsigned kFull = 0xffffffffu;

// y -> a*y + y0; after a row start inside the run (f) the map is y0 alone
struct Map {
  float a, y;
  int f;
};

__device__ __forceinline__ Map compose(Map p, Map c) {   // p, then c
  if (c.f) return c;
  return {c.a * p.a, fmaf(c.a, p.y, c.y), p.f};
}

__device__ __forceinline__ Map shfl_up(Map m, int d) {
  return {__shfl_up_sync(kFull, m.a, d), __shfl_up_sync(kFull, m.y, d),
          __shfl_up_sync(kFull, m.f, d)};
}

struct Params {
  const float* x;
  const float* x_prev;
  const float* y_prev;
  float* y;
  float* x_last;
  float* y_last;
  int rows, n;
  int rows_per_cta;   // whole rows a CTA (parts == 1)
  int parts;          // CTAs a row, one cluster (> 1), else 1
  int chunk;          // samples a CTA of a cut row; on the short-row path,
                      // floats of a warp's buffer
  int run;            // short-row path: samples a lane (odd)
  float b0, b1, a1;
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

__device__ __forceinline__ float c_of(float b0, float b1, float x, float xb) {
  return __fadd_rn(__fmul_rn(b0, x), __fmul_rn(b1, xb));
}

// Offset (in floats, 0..3) of a pointer within its 16-byte line
__device__ __forceinline__ int line_offset(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__global__ void __launch_bounds__(kMaxThreads) iir_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float xps[kMaxRowsPerCta], yps[kMaxRowsPerCta];
  __shared__ Map warp_map[kMaxWarps];
  __shared__ Map cta_map;
  __shared__ float carry_y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int n = p.n;

  // this CTA's piece of the flat array: rows [r0, r0 + nrows) whole, or
  // the chunk `part` of row r0
  int r0, nrows, part = 0, col0 = 0, len;
  if (p.parts > 1) {
    r0 = blockIdx.x / p.parts;
    part = blockIdx.x - r0 * p.parts;
    col0 = part * p.chunk;
    len = max(0, min(n - col0, p.chunk));
    nrows = part == 0 ? 1 : 0;
  } else {
    r0 = blockIdx.x * p.rows_per_cta;
    nrows = min(p.rows_per_cta, p.rows - r0);
    len = nrows * n;
  }
  const size_t start = (size_t)r0 * n + col0;
  const float* src = p.x + start;

  // 1. stage the piece: unaligned head and tail by 4 bytes, the body by 16
  const int off = line_offset(src);
  float* s = smem + off;
  const int head = min(len, (4 - off) & 3);
  const int body_end = head + ((len - head) & ~3);
  for (int i = tid; i < head; i += blockDim.x) cp_async4(s + i, src + i);
  for (int i = head + 4 * tid; i < body_end; i += 4 * blockDim.x)
    cp_async16(s + i, src + i);
  for (int i = body_end + tid; i < len; i += blockDim.x) cp_async4(s + i, src + i);
  for (int k = tid; k < nrows; k += blockDim.x) {
    xps[k] = p.x_prev[r0 + k];
    yps[k] = p.y_prev[r0 + k];
  }
  const int i0 = tid * kPer;
  const int cnt = max(0, min(kPer, len - i0));     // this thread's samples
  // x before this thread's run (a row start replaces it)
  const float x_cta = (part > 0 && i0 == 0) ? __ldg(src - 1) : 0.f;
  cp_async_wait_all();
  __syncthreads();

  // 2. this run's samples and map; (row, column) of its first sample
  float xv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) xv[i] = i < cnt ? s[i0 + i] : 0.f;
  const int rl0 = p.parts > 1 ? 0 : (cnt > 0 ? i0 / n : 0);
  const int c0 = p.parts > 1 ? col0 + i0 : i0 - rl0 * n;
  const float xb0 = i0 > 0 ? (cnt > 0 ? s[i0 - 1] : 0.f) : x_cta;
  const float b0 = p.b0, b1 = p.b1, a1 = p.a1;
  Map m{1.f, 0.f, 0};
  {
    float xb = xb0;
    int c = c0, rl = rl0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i < cnt) {
        if (c == 0) {
          m = {0.f, fmaf(a1, yps[rl], c_of(b0, b1, xv[i], xps[rl])), 1};
        } else {
          m.y = fmaf(a1, m.y, c_of(b0, b1, xv[i], xb));
          m.a *= a1;
        }
        xb = xv[i];
        if (++c == n) {
          c = 0;
          ++rl;
        }
      }
    }
  }

  // 3. CTA-wide scan of the maps: inclusive in the warp, then the warps'
  // totals scanned by warp 0
  Map inc = m;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map q = shfl_up(inc, d);
    if (lane >= d) inc = compose(q, inc);
  }
  Map ex = shfl_up(inc, 1);
  if (lane == 0) ex = {1.f, 0.f, 0};
  if (lane == 31) warp_map[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Map t = lane < nw ? warp_map[lane] : Map{1.f, 0.f, 0};
#pragma unroll
    for (int d = 1; d < kMaxWarps; d <<= 1) {
      const Map q = shfl_up(t, d);
      if (lane >= d) t = compose(q, t);
    }
    Map e = shfl_up(t, 1);
    if (lane == 0) e = {1.f, 0.f, 0};
    if (lane < nw) warp_map[lane] = e;
    if (lane == nw - 1) cta_map = t;
  }
  __syncthreads();
  const Map pre = compose(warp_map[warp], ex);

  // the carry into a cut row's chunk: the maps of the chunks before it,
  // read from the other CTAs of the cluster
  float y_cta = 0.f;
  if (p.parts > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (tid == 0) {
      Map acc{1.f, 0.f, 0};
      for (int r = 0; r < part; ++r)
        acc = compose(acc, *cluster.map_shared_rank(&cta_map, r));
      carry_y = acc.y;
    }
    __syncthreads();
    y_cta = carry_y;
  }

  // 4. replay the run from its carry-in, y in place of x
  {
    float yv = pre.f ? pre.y : fmaf(pre.a, y_cta, pre.y);
    float xb = xb0;
    int c = c0, rl = rl0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i < cnt) {
        if (c == 0)
          yv = fmaf(a1, yps[rl], c_of(b0, b1, xv[i], xps[rl]));
        else
          yv = fmaf(a1, yv, c_of(b0, b1, xv[i], xb));
        s[i0 + i] = yv;
        if (c == n - 1) {
          p.x_last[r0 + rl] = xv[i];
          p.y_last[r0 + rl] = yv;
        }
        xb = xv[i];
        if (++c == n) {
          c = 0;
          ++rl;
        }
      }
    }
  }
  __syncthreads();

  // 5. the piece out, coalesced (16-byte stores when y lines up with x)
  float* dst = p.y + start;
  if (line_offset(dst) == off) {
    for (int i = tid; i < head; i += blockDim.x) dst[i] = s[i];
    for (int i = head + 4 * tid; i < body_end; i += 4 * blockDim.x)
      *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(s + i);
    for (int i = body_end + tid; i < len; i += blockDim.x) dst[i] = s[i];
  } else {
    for (int i = tid; i < len; i += blockDim.x) dst[i] = s[i];
  }
  if (p.parts > 1) cg::this_cluster().sync();   // others may still read cta_map
}

// Short rows (the AM bank's 600 samples): one warp a row, the row staged
// whole in the warp's own buffer, lane l a run of `run` samples (odd: the
// runs' reads miss no bank), a warp scan of the runs' maps.  No block-wide
// barrier: every warp loads, scans and stores on its own, so one row's
// stores overlap the next one's loads.
__global__ void __launch_bounds__(kRowWarps * 32) iir_rows_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowWarps + warp;
  if (row >= p.rows) return;
  const int n = p.n, run = p.run;
  const float* src = p.x + (size_t)row * n;
  const int off = line_offset(src);
  float* s = smem + warp * p.chunk + off;
  const int head = min(n, (4 - off) & 3);
  const int body_end = head + ((n - head) & ~3);
  for (int i = lane; i < head; i += 32) cp_async4(s + i, src + i);
  for (int i = head + 4 * lane; i < body_end; i += 128) cp_async16(s + i, src + i);
  for (int i = body_end + lane; i < n; i += 32) cp_async4(s + i, src + i);
  const float xp = p.x_prev[row], yp = p.y_prev[row];
  cp_async_wait_all();
  __syncwarp();

  const float b0 = p.b0, b1 = p.b1, a1 = p.a1;
  const int i0 = lane * run, cnt = max(0, min(run, n - i0));
  const float xb0 = i0 == 0 ? xp : (cnt > 0 ? s[i0 - 1] : 0.f);
  // the run in registers, all loads issued before the recurrence needs them
  float xv[kMaxRun];
#pragma unroll
  for (int i = 0; i < kMaxRun; ++i) xv[i] = i < cnt ? s[i0 + i] : 0.f;
  Map m{1.f, 0.f, 0};
  float xb = xb0;
#pragma unroll
  for (int i = 0; i < kMaxRun; ++i) {
    if (i >= cnt) break;
    const float x = xv[i], c = c_of(b0, b1, x, xb);
    if (i0 + i == 0) {
      m = {0.f, fmaf(a1, yp, c), 1};
    } else {
      m.y = fmaf(a1, m.y, c);
      m.a *= a1;
    }
    xb = x;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map q = shfl_up(m, d);
    if (lane >= d) m = compose(q, m);
  }
  Map pre = shfl_up(m, 1);
  float yv = lane == 0 ? 0.f : pre.y;     // lane 0 starts the row itself
  xb = xb0;
#pragma unroll
  for (int i = 0; i < kMaxRun; ++i) {
    if (i >= cnt) break;
    const float x = xv[i], c = c_of(b0, b1, x, xb);
    yv = i0 + i == 0 ? fmaf(a1, yp, c) : fmaf(a1, yv, c);
    s[i0 + i] = yv;
    xb = x;
  }
  if (cnt > 0 && i0 + cnt == n) {
    p.x_last[row] = xb;
    p.y_last[row] = yv;
  }
  __syncwarp();
  float* dst = p.y + (size_t)row * n;
  if (line_offset(dst) == off) {
    for (int i = lane; i < head; i += 32) dst[i] = s[i];
    for (int i = head + 4 * lane; i < body_end; i += 128)
      *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(s + i);
    for (int i = body_end + lane; i < n; i += 32) dst[i] = s[i];
  } else {
    for (int i = lane; i < n; i += 32) dst[i] = s[i];
  }
}

}  // namespace

// x, y: (rows, n) float32; x_prev, y_prev, x_last, y_last: (rows,) float32.
// All contiguous; n at most 8 * 3840 (longer rows are split by the caller).
extern "C" int iir_launch(const void* x, const void* x_prev,
                          const void* y_prev, void* y, void* x_last,
                          void* y_last, int rows, int n, float b0, float b1,
                          float a1, void* stream) {
  if (rows <= 0 || n <= 0 || n > kMaxParts * kMaxChunk)
    return (int)cudaErrorInvalidValue;
  if (n <= kShortRow) {
    const int stride = (n + 4 + 3) & ~3;    // floats a warp, 16-byte lines
    const int run = ((n + 31) / 32) | 1;
    Params p{static_cast<const float*>(x), static_cast<const float*>(x_prev),
             static_cast<const float*>(y_prev), static_cast<float*>(y),
             static_cast<float*>(x_last), static_cast<float*>(y_last),
             rows, n, 1, 1, stride, run, b0, b1, a1};
    iir_rows_kernel<<<(rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32,
                      (size_t)stride * kRowWarps * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
  }
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  // about kCtasPerSm CTAs an SM: rows cut into up to 8 chunks when they
  // are few, whole rows grouped when they are short and many
  const long long want = (long long)kCtasPerSm * sms;
  int parts = (n + kMaxChunk - 1) / kMaxChunk;
  if (rows < want) {
    const int more = (int)std::min<long long>((want + rows - 1) / rows,
                                              (n + kMinChunk - 1) / kMinChunk);
    parts = std::max(parts, std::min(kMaxParts, more));
  }
  parts = std::min(std::max(parts, 1), kMaxParts);
  int chunk = n, rpc = 1;
  if (parts > 1) {
    chunk = ((n + parts - 1) / parts + 3) & ~3;
  } else {
    rpc = std::max(1, std::min(kMaxChunk / n, kMaxRowsPerCta));
    rpc = (int)std::min<long long>(rpc, (rows + want - 1) / want);
  }
  if (chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  const int len = parts > 1 ? chunk : rpc * n;
  const int threads = ((len + kPer - 1) / kPer + 31) & ~31;
  const size_t smem = (size_t)(len + 4) * sizeof(float);
  Params p{static_cast<const float*>(x), static_cast<const float*>(x_prev),
           static_cast<const float*>(y_prev), static_cast<float*>(y),
           static_cast<float*>(x_last), static_cast<float*>(y_last),
           rows, n, rpc, parts, chunk, 0, b0, b1, a1};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts > 1 ? (unsigned)rows * parts : (unsigned)((rows + rpc - 1) / rpc));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, iir_kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* owrx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
