// Chunked AGC, the whole of agc_apply in one launch: per row, the peak
// |x| of each chunk, the attack/decay/hang gain recurrence over the chunks,
// and the hold-with-ramp gain interpolation multiplied into the samples.
//
// Replaces: the lax.scan of openwebrx_tpu/ops/agc.py (agc_apply, the step
// over chunk peaks) with the reductions and the ramp around it, which the
// port's plain version runs as a Python loop of ~10 small launches per
// chunk.  Not a Pallas kernel: XLA lowers the scan itself.
//
// What bounds it on the card: bytes.  At the NFM bank's shape (1024 rows x
// 2400 samples, 48 chunks of 50) it reads x once and writes y once, 19.7 MB
// (5.9 us at 3.35 TB/s), and does ~6 flop per sample (0.2 us).  The only
// serial part is the gain recurrence: per chunk 6 dependent float32
// operations (subtract, multiply, add, select, the clamp's max and min),
// 48 chunks per row.  chip_smoke.py measures its time per chunk: the slope
// between one-row launches of 48 and 96 chunks.
//
// Design: nothing but that recurrence sits on the serial chain.  A CTA owns
// a few whole rows (about four CTAs per SM; up to kTileFloats samples, and
// longer rows are walked in tiles of whole chunks) and per tile:
//   1. stages the rows in shared memory with 16-byte cp.async (4-byte when
//      a row is not 16-byte aligned), so x is read from device memory once;
//   2. in parallel over (row, chunk), a power-of-two group of threads takes
//      the chunk's peak, and its leader computes env = max(peak, 1e-9) and
//      target = reference / env (IEEE divide), none of which needs the gain;
//   3. one thread per row runs the recurrence over the tile's targets,
//      read from shared memory eight at a time ahead of the steps, and
//      leaves (gain before the chunk, gain after it minus that) per chunk;
//   4. all threads apply x * (g_prev + (g - g_prev) * ramp) from the staged
//      x with 16-byte stores; ramp[j] = j / chunk is divided once per CTA
//      into a shared table.
// The arithmetic repeats the plain version's float32 operations in its
// order with round-to-nearest intrinsics (no contraction into fused
// multiply-adds), and the clamps propagate NaN as torch.clamp does, so the
// final gain, the hang counters and the audio equal the plain version's
// bit for bit.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 8192;    // staged x per CTA: 32 KB
constexpr int kTargetCtas = 528;     // four per SM of a 132-SM H100
constexpr int kMaxRowsPerCta = 32;   // the recurrence threads fit in warp 0
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* x;
  const float* gain0;
  const int* hang0;
  float* y;
  float* gain_out;
  int* hang_out;
  int rows, n, chunk;
  int rows_per_cta;   // rows a CTA owns
  int tile_chunks;    // chunks per row staged at once
  int hang_chunks;
  float attack, decay, reference, max_gain;
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

// torch.clamp's NaN-propagating max and min
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// kVec: rows staged with 16-byte copies and written with 16-byte stores
// (n % 4 == 0, 16-byte aligned x and y); else 4 bytes at a time.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) agc_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = p.chunk;
  const int tc = p.tile_chunks;
  const int ld = (tc * chunk + 3) & ~3;   // row stride of the staged tile
  const int ts = tc | 1;                  // odd strides: no bank conflicts
  const int gs = tc | 1;                  // between the recurrence threads
  const int rpc = p.rows_per_cta;
  float* xs = smem;                       // [rpc][ld]
  float* target = xs + rpc * ld;          // [rpc][ts]
  float2* gains = reinterpret_cast<float2*>(target + rpc * ts + (rpc * ts & 1));
  float* ramp = reinterpret_cast<float*>(gains + rpc * gs);   // [chunk]
  // gains[r][c] = (gain before chunk c, gain after it minus that)
  const int row0 = blockIdx.x * rpc;
  const int nr = min(rpc, p.rows - row0);
  const int tid = threadIdx.x;
  const float attack = p.attack, decay = p.decay, max_gain = p.max_gain;
  const int hang_chunks = p.hang_chunks;

  for (int j = tid; j < chunk; j += kThreads)
    ramp[j] = __fdiv_rn((float)j, (float)chunk);
  float g = 0.f;
  int h = 0;
  if (tid < nr) {
    g = p.gain0[row0 + tid];
    h = p.hang0[row0 + tid];
  }

  const int nchunks = p.n / chunk;
  for (int c0 = 0; c0 < nchunks; c0 += tc) {
    const int tcn = min(tc, nchunks - c0);   // chunks in this tile
    const int len = tcn * chunk;             // samples per row in it
    const float* xg = p.x + (size_t)row0 * p.n + (size_t)c0 * chunk;
    float* yg = p.y + (size_t)row0 * p.n + (size_t)c0 * chunk;

    // 1. stage the tile: every load in flight at once
    if (kVec) {
      const int q = len >> 2;
      const float inv_q = 1.f / (float)q;
      for (int k = tid; k < nr * q; k += kThreads) {
        const int r = div_small(k, q, inv_q);
        const int i = (k - r * q) << 2;
        cp_async16(xs + r * ld + i, xg + (size_t)r * p.n + i);
      }
    } else {
      const float inv_len = 1.f / (float)len;
      for (int k = tid; k < nr * len; k += kThreads) {
        const int r = div_small(k, len, inv_len);
        const int i = k - r * len;
        cp_async4(xs + r * ld + i, xg + (size_t)r * p.n + i);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. chunk peaks and targets, off the chain
    const int tasks = nr * tcn;
    int sub = 32;                            // threads per chunk
    while (sub > 1 && tasks * sub > kThreads) sub >>= 1;
    const int lsub = __ffs(sub) - 1;
    const int span = (tasks * sub + kThreads - 1) / kThreads * kThreads;
    const float inv_tcn = 1.f / (float)tcn;
    for (int k = tid; k < span; k += kThreads) {   // uniform trip count
      const int task = k >> lsub;
      const int part = k & (sub - 1);
      int r = 0, c = 0;
      float p0 = 0.f, p1 = 0.f;              // |x| >= 0: 0 is max's identity
      if (task < tasks) {
        r = div_small(task, tcn, inv_tcn);
        c = task - r * tcn;
        const float* xc = xs + r * ld + c * chunk;
        int i = part;
#pragma unroll 4
        for (; i + sub < chunk; i += 2 * sub) {
          p0 = fmaxf(p0, fabsf(xc[i]));
          p1 = fmaxf(p1, fabsf(xc[i + sub]));
        }
        if (i < chunk) p0 = fmaxf(p0, fabsf(xc[i]));
      }
      float peak = fmaxf(p0, p1);
      for (int off = sub >> 1; off > 0; off >>= 1)
        peak = fmaxf(peak, __shfl_xor_sync(kFull, peak, off));
      if (task < tasks && part == 0) {
        const float env = peak < 1e-9f ? 1e-9f : peak;
        target[r * ts + c] = __fdiv_rn(p.reference, env);
      }
    }
    __syncthreads();

    // 3. the recurrence: one thread per row, 6 dependent operations a
    // chunk.  Targets are read eight at a time ahead of the steps that use
    // them, so no shared-memory load waits on the chain.
    if (tid < nr) {
      const float* tr = target + tid * ts;
      float2* gr = gains + tid * gs;
      auto step = [&](float t, int c) {
        const bool attacking = t < g;
        const float d = __fsub_rn(t, g);
        const float g_att = __fadd_rn(g, __fmul_rn(attack, d));
        const float g_dec = __fadd_rn(g, __fmul_rn(decay, d));
        const int h_new = attacking ? hang_chunks : max(h - 1, 0);
        const float g_sel = attacking ? g_att : (h > 0 ? g : g_dec);
        const float g_new = min_nan(max_nan(g_sel, 1e-6f), max_gain);
        gr[c] = make_float2(g, __fsub_rn(g_new, g));
        g = g_new;
        h = h_new;
      };
      int c = 0;
      for (; c + 8 <= tcn; c += 8) {
        float t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) t[u] = tr[c + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) step(t[u], c + u);
      }
      for (; c < tcn; ++c) step(tr[c], c);
    }
    __syncthreads();

    // 4. hold-with-ramp gain times x, from the staged tile, four samples
    // a thread with 16-byte stores
    if (kVec) {
      const int q = len >> 2;
      const float inv_q = 1.f / (float)q;
      const float inv_chunk = 1.f / (float)chunk;
      for (int k = tid; k < nr * q; k += kThreads) {
        const int r = div_small(k, q, inv_q);
        const int i = (k - r * q) << 2;
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * ld + i);
        int c = div_small(i, chunk, inv_chunk);
        int j = i - c * chunk;
        float2 gd = gains[r * gs + c];
        const float in[4] = {xv.x, xv.y, xv.z, xv.w};
        float out[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          out[u] = __fmul_rn(in[u], __fadd_rn(gd.x, __fmul_rn(gd.y, ramp[j])));
          if (++j == chunk && u < 3) {
            j = 0;
            gd = gains[r * gs + ++c];
          }
        }
        *reinterpret_cast<float4*>(yg + (size_t)r * p.n + i) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
    } else {
      const float inv_len = 1.f / (float)len;
      const float inv_chunk = 1.f / (float)chunk;
      for (int k = tid; k < nr * len; k += kThreads) {
        const int r = div_small(k, len, inv_len);
        const int i = k - r * len;
        const int c = div_small(i, chunk, inv_chunk);
        const float2 gd = gains[r * gs + c];
        yg[(size_t)r * p.n + i] = __fmul_rn(
            xs[r * ld + i], __fadd_rn(gd.x, __fmul_rn(gd.y, ramp[i - c * chunk])));
      }
    }
    __syncthreads();   // the next tile overwrites xs and gains
  }
  if (tid < nr) {
    p.gain_out[row0 + tid] = g;
    p.hang_out[row0 + tid] = h;
  }
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

}  // namespace

// x, y: (rows, n) float32, n a multiple of chunk; gain0, gain_out: (rows,)
// float32; hang0, hang_out: (rows,) int32.  All contiguous.
extern "C" int agc_launch(const void* x, const void* gain0, const void* hang0,
                          void* y, void* gain_out, void* hang_out, int rows,
                          int n, int chunk, float attack, float decay,
                          int hang_chunks, float reference, float max_gain,
                          void* stream) {
  if (rows <= 0 || chunk <= 0 || n <= 0 || n % chunk != 0 || chunk > kTileFloats)
    return (int)cudaErrorInvalidValue;
  const int nchunks = n / chunk;
  bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int n_pad = (n + 3) & ~3;
  int rpc = (rows + kTargetCtas - 1) / kTargetCtas;
  rpc = std::min(std::min(rpc, kMaxRowsPerCta), std::max(1, kTileFloats / n_pad));
  int tc = nchunks;
  if (n_pad > kTileFloats) {   // rpc == 1: walk the row in tiles
    tc = kTileFloats / chunk;
    if (vec) {
      const int m = 4 / gcd(chunk, 4);   // 16-byte aligned tile starts
      if (tc >= m) tc -= tc % m;
      else vec = false;
    }
  }
  const int ld = (tc * chunk + 3) & ~3;
  const size_t smem = sizeof(float) *
      ((size_t)rpc * (ld + (tc | 1) + 2 * (tc | 1)) + 1 + (size_t)chunk);
  Params p{static_cast<const float*>(x), static_cast<const float*>(gain0),
           static_cast<const int*>(hang0), static_cast<float*>(y),
           static_cast<float*>(gain_out), static_cast<int*>(hang_out),
           rows, n, chunk, rpc, tc, hang_chunks, attack, decay, reference,
           max_gain};
  const int blocks = (rows + rpc - 1) / rpc;
  auto kernel = vec ? agc_kernel<true> : agc_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* owrx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
