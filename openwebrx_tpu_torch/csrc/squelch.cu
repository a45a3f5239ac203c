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
// one to four windows on the paths.  At the banks' shapes (4.9 MB or
// less) a plain device copy of the same bytes already takes about twice
// the bound, so what counts there is how short each CTA's chain from its
// first byte landed to its last store is.
//
// Design.  The launch plan (cluster, warps, slice, chunk, stages, copy
// width) comes from ops/squelch.py squelch_plan; this file checks it and
// runs it.  Three shapes of work:
//   - Registers (rows of up to 64 KB in whole 16-byte vectors a window,
//     every path but WFM and the server's NFM bank): a CTA a row, each
//     thread holding its share of one window in registers, loaded straight
//     from x (squelch_regs_kernel).  At rows of a few KB the set-up of a
//     stage buffer and its mbarrier is most of a CTA's time.
//   - Rows (other rows of up to 100 KB): a CTA a row, no cluster, staged.
//     A row whose windows do not all fit in shared memory (tens of
//     thousands of short windows, or a row too long for slices) is walked
//     in chunks of whole windows through two stages, the hang carried
//     from chunk to chunk.
//   - Slices (longer rows: the WFM bank's 400 KB): a row is cut into C
//     slices (C in 2, 4, 8), one CTA each, launched as a thread-block
//     cluster of C.  A window may straddle two CTAs.
// Staged, thread 0 stages the CTA's piece with one TMA 1-D bulk copy
// (cp.async.bulk on an mbarrier) and the other threads wait on the
// mbarrier, spending no instruction on addresses.  The window sums take
// a power-of-two group of threads a window, 16 bytes a load where the
// windows lie on 16-byte edges, a butterfly within each warp, and leave
// one partial a warp in shared memory in a fixed place: no block-wide
// barrier inside.  After one __syncthreads:
//   - registers and rows mode: every warp adds the partials in warp order
//     and runs the hang itself (with one window a row or chunk, every
//     thread decides its gate; with more, the recurrence in closed form
//     over 32 windows at a time: a ballot of the windows above the level
//     and the distance to the last of them), so the gates need no second
//     barrier; then all threads write y, from registers or the stage;
//   - slice mode: the CTA's sums go where the cluster reads them, a
//     cluster barrier, and every warp adds each window's sums over the
//     CTAs it spans in rank order through distributed shared memory (the
//     same bits in every CTA of the row), runs the hang over all of the
//     row's windows from the row's start state and writes y of its share
//     of the slice; the CTA that holds a window's first sample writes its
//     power_db, rank 0 the new state.  A second cluster barrier, arrived at
//     once a thread's remote reads are done and waited on at the end,
//     keeps every CTA's sums alive while others read them.
// A piece longer than the shared memory holds (a row of more than eight
// CTAs' worth, which no path gives) is streamed through up to four
// stages into running sums, and its y written from a second read of x
// (the re-read branch).  A piece that is not 16-byte aligned (a row of an
// odd number of floats, or x at an unaligned address) is staged by 4-byte
// cp.async from every thread, whose completion the same mbarrier tracks
// (cp.async.mbarrier.arrive.noinc), and written 4 bytes at a time.
// Measured on an H100 and given up (PERF.md §6): a ring of row units a
// CTA (each unit's chain ran serially), a warp a row or a warp a piece
// (too much serial work a thread), cluster slices for short rows (the
// cluster's start and barriers cost more than spreading the bytes gains),
// a slice staged in several chunks, 16-byte cp.async in place of the bulk
// copy, 16 warps a CTA, a store that walks window by window, persistent
// clusters that prefetch the next row's slice while storing this one, and
// the cluster launch for a plan without a cluster.
// The output is y = gate ? x : +0.0, a select (x * 0 would keep -0.0).
// |x|^2 of a complex sample is re^2 + im^2, and +inf where either part is
// infinite, as |x| (a hypot) is; the dB is 10 log10(max(p, 1e-30)),
// NaN-propagating as torch.clamp.  The window sums are taken in another
// order than torch.mean, so power_db matches the plain version within a
// stated tolerance and the gates wherever the power is not that close to
// the level.  The order depends on the plan alone: two runs of the same
// input give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxStages = 4;
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kWaitLimit = 1ll << 33;   // clocks (~4 s): a lost copy traps

struct Params {
  const float* x;          // (rows, n * cplx) floats
  const float* level;      // (rows,) or (1,): level_stride 1 or 0
  const unsigned char* open0;
  const int* hang0;
  float* y;
  float* power_db;         // (rows, n / window)
  unsigned char* open_out;
  int* hang_out;
  int rows, n, window, level_stride, hang_windows;
  int cluster;             // CTAs a row (slice mode), 1 in rows mode
  int warps;               // warps a CTA
  int slice;               // slice mode: floats of a row a CTA owns; 0 in rows mode
  int chunk;               // floats a stage buffer holds (rows mode: whole windows)
  int stages;              // stage buffers
};

// The dynamic shared memory of a plan, in floats from its start: the
// stages; a chunk's window sums, a slot for each warp of a window (wp);
// slice mode: the piece's window sums (acc); each warp's powers, then
// gates, of the windows it decides (pdb: the row's in slice mode, a
// chunk's in rows mode).  ops/squelch.py squelch_smem mirrors `end`.
struct Layout {
  long long wp, acc, pdb, per_warp, end;
};

__host__ __device__ inline Layout layout_of(int n, int window, int cplx, int warps, int slice,
                                            int chunk, int stages) {
  const long long wf = (long long)window * cplx;
  Layout l;
  l.wp = (long long)stages * chunk;
  l.acc = l.wp + (chunk / wf + 2) * warps;
  l.pdb = l.acc + (slice ? slice / wf + 2 : 0);
  l.per_warp = slice ? n / window : chunk / wf;
  l.end = l.pdb + warps * l.per_warp;
  return l;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Wait for the phase of the given parity; trap (a launch error on the
// host) rather than spin for ever should a copy never land.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  long long t0 = -1;
  while (true) {
    asm volatile(
        "{\n.reg .pred q;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2;\n"
        "selp.u32 %0, 1, 0, q;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long t = clock64();
    if (t0 < 0) t0 = t;
    else if (t - t0 > kWaitLimit) __trap();
  }
}

// Stage floats [0, len) of src at dst, completing one phase of `bar`:
// kVec, one bulk copy issued by thread 0 (16-byte aligned and sized); else
// every thread copies 4 bytes at a time and arrives when its copies land
// (the barrier counts one arrival a thread).
template <bool kVec>
__device__ __forceinline__ void stage(float* dst, const float* src, int len,
                                      unsigned bar, int tid, int nthreads) {
  if (kVec) {
    if (tid == 0) {
      const unsigned bytes = (unsigned)len * 4u;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
          "l"(src), "r"(bytes), "r"(bar)
          : "memory");
    }
  } else {
    for (int k = tid; k < len; k += nthreads) cp_async4(dst + k, src + k);
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
                 : "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

__device__ __forceinline__ float inv_window_of(int window) { return 1.f / (float)window; }

__device__ __forceinline__ float to_db(float sum, float inv_window) {
  return __fmul_rn(10.f, log10f(max_nan(__fmul_rn(sum, inv_window), 1e-30f)));
}

// |x|^2 of one sample: re^2 + im^2, or x^2 for real input
template <int kCplx>
__device__ __forceinline__ float power_of(const float* s) {
  if (kCplx == 1) return __fmul_rn(s[0], s[0]);
  const float2 v = *reinterpret_cast<const float2*>(s);
  const float q = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
  return (isinf(v.x) || isinf(v.y)) ? __int_as_float(0x7f800000) : q;
}

// The threads that sum one window when `tasks` windows share n threads:
// a power of two, whole warps only when there are fewer windows than warps.
__host__ __device__ __forceinline__ int group_of(int tasks, int n) {
  int sub = 1;
  while (sub < n && tasks * sub * 2 <= n) sub <<= 1;
  return sub;
}

// |x|^2 of the samples of 16 bytes, in sample order
template <int kCplx>
__device__ __forceinline__ float power4(float4 v) {
  if (kCplx == 1)
    return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
                               __fmul_rn(v.z, v.z)),
                     __fmul_rn(v.w, v.w));
  float a = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
  float b = __fadd_rn(__fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w));
  const float s = __fadd_rn(a, b);
  if (s == s) return s;   // no NaN: an infinite part already gives +inf
  const float inf = __int_as_float(0x7f800000);   // (inf, NaN) is +inf, as hypot
  if (isinf(v.x) || isinf(v.y)) a = inf;
  if (isinf(v.z) || isinf(v.w)) b = inf;
  return __fadd_rn(a, b);
}

// Sum |x|^2 over every window's part in the staged floats xs[0, len),
// whose first float lies `off` floats into the first window touched, with
// the CTA's n threads and no block-wide barrier: group_of(tasks, n)
// threads a window, a butterfly within each warp, and each warp of a
// window calls emit(t, w, sum) for its part (w: the warp's place among
// the window's warps, 0 when a window takes a warp or less).  The order
// depends on (len, off, wf, n) alone.
template <int kCplx, class Emit>
__device__ __forceinline__ void window_sums(const float* xs, int len, int off, int wf,
                                            int tid, int n, Emit emit) {
  const int tasks = (off + len + wf - 1) / wf;
  const int sub = group_of(tasks, n);
  // every window edge and the piece's ends on 16-byte boundaries of xs
  const bool vec = ((wf | off | len) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(xs) & 15) == 0;
  const int lsub = __ffs(sub) - 1;
  const int span = (tasks * sub + n - 1) / n * n;
  for (int k = tid; k < span; k += n) {   // uniform trip count
    const int task = k >> lsub;
    const int part_i = k & (sub - 1);
    float s0 = 0.f, s1 = 0.f;
    if (task < tasks) {
      const int lo = max(task * wf - off, 0);
      const int hi = min((task + 1) * wf - off, len);
      const float* xc = xs + lo;
      if (vec) {   // 16 bytes a load: the sum of their samples' powers
        const float4* x4 = reinterpret_cast<const float4*>(xc);
        const int m = (hi - lo) >> 2;
        int i = part_i;
#pragma unroll 4
        for (; i + sub < m; i += 2 * sub) {
          s0 = __fadd_rn(s0, power4<kCplx>(x4[i]));
          s1 = __fadd_rn(s1, power4<kCplx>(x4[i + sub]));
        }
        if (i < m) s0 = __fadd_rn(s0, power4<kCplx>(x4[i]));
      } else {
        const int m = (hi - lo) / kCplx;   // samples
        int i = part_i;
#pragma unroll 4
        for (; i + sub < m; i += 2 * sub) {
          s0 = __fadd_rn(s0, power_of<kCplx>(xc + i * kCplx));
          s1 = __fadd_rn(s1, power_of<kCplx>(xc + (i + sub) * kCplx));
        }
        if (i < m) s0 = __fadd_rn(s0, power_of<kCplx>(xc + i * kCplx));
      }
    }
    float s = __fadd_rn(s0, s1);
    for (int o = min(sub, 32) >> 1; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
    if (task < tasks && (part_i & 31) == 0) emit(task, part_i >> 5, s);
  }
}

// The hang over windows [0, nwin) of a row, 32 windows at a time, by one
// warp: window c is open when it is above its level (pdb[c] dB > level,
// false for NaN) or the hang counter after it is positive, the counter
// being hang_windows at the last window above and one less each window
// on (never below 0), or the start counter h less c + 1 when no window
// before it was above: the plain version's recurrence in closed form.
// Writes the gate (int) over pdb[c]; leaves the state after the last
// window in (open, h) of every lane.
__device__ __forceinline__ void hang_gates(float* pdb, int nwin, float level, int hw,
                                           bool& open, int& h, int lane) {
  int* gate = reinterpret_cast<int*>(pdb);
  for (int c0 = 0; c0 < nwin; c0 += 32) {
    const int c = c0 + lane;
    const bool above = c < nwin && pdb[c] > level;
    const unsigned prior = __ballot_sync(kFull, above) & (0xffffffffu >> (31 - lane));
    int hc;
    if (prior) {
      const int last = 31 - __clz(prior);
      hc = last == lane ? hw : max(hw - (lane - last), 0);
    } else {
      hc = max(h - (lane + 1), 0);
    }
    const bool g = above || hc > 0;
    if (c < nwin) gate[c] = g;
    const int tail = min(31, nwin - 1 - c0);
    h = __shfl_sync(kFull, hc, tail);
    open = __shfl_sync(kFull, g, tail);
  }
}

// y = gate ? x : +0.0 for floats [0, len) of a piece whose first float
// lies `off` floats into its first window, by the CTA's n threads;
// gate[t] of each window touched.
template <bool kVec>
__device__ __forceinline__ void gated_store(float* dst, const float* src, int len, int off,
                                            int wf, const int* gate, int tid, int n) {
  const float inv_wf = 1.f / (float)wf;
  if (off + len <= wf) {                  // one window: one gate for the piece
    if (!gate[0]) {
      if (kVec)
#pragma unroll 4
        for (int i = 4 * tid; i < len; i += 4 * n)
          *reinterpret_cast<float4*>(dst + i) = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        for (int i = tid; i < len; i += n) dst[i] = 0.f;
    } else if (kVec) {
#pragma unroll 4
      for (int i = 4 * tid; i < len; i += 4 * n)
        *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(src + i);
    } else {
      for (int i = tid; i < len; i += n) dst[i] = src[i];
    }
    return;
  }
  if (kVec) {
    for (int i = 4 * tid; i < len; i += 4 * n) {
      float4 v = *reinterpret_cast<const float4*>(src + i);
      const int t = div_small(off + i, wf, inv_wf);
      if (off + i + 3 < (t + 1) * wf) {      // one window for all four
        if (!gate[t]) v = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (!gate[div_small(off + i + u, wf, inv_wf)]) e[u] = 0.f;
        v = make_float4(e[0], e[1], e[2], e[3]);
      }
      *reinterpret_cast<float4*>(dst + i) = v;
    }
  } else {
    for (int i = tid; i < len; i += n)
      dst[i] = gate[div_small(off + i, wf, inv_wf)] ? src[i] : 0.f;
  }
}

// Rows mode with the row in registers (plan stages 0): group_of(nwin, T)
// threads a window, each holding up to kRegs of its window's 16-byte
// vectors, loaded straight from x; the sums as window_sums takes them,
// one __syncthreads, every warp its gates as the staged kernel does, and
// y stored from the registers.  No stage buffer, no mbarrier: at rows of
// a few KB their set-up is most of a CTA's time.
template <int kCplx, int kRegs>
__global__ void __launch_bounds__(kMaxWarps * 32) squelch_regs_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = p.warps, T = W * 32;
  const int rowf = p.n * kCplx, wf = p.window * kCplx, nwin = p.n / p.window;
  const int row = (int)blockIdx.x;
  const int m = wf >> 2;                         // vectors a window
  const int sub = group_of(nwin, T);             // nwin * sub <= T
  const int task = tid >> (__ffs(sub) - 1), part = tid & (sub - 1);
  const bool mine = task < nwin;
  const size_t at = (size_t)row * (rowf >> 2) + (size_t)task * m;
  const float4* x4 = reinterpret_cast<const float4*>(p.x) + at;
  float4 v[kRegs];
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    const int i = part + j * sub;
    v[j] = mine && i < m ? __ldg(x4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the row's state, read while the loads fly
  const float level = p.level[row * p.level_stride];
  bool open = p.open0[row] != 0;
  int h = p.hang0[row];
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < kRegs; j += 2) {
    s0 = __fadd_rn(s0, power4<kCplx>(v[j]));
    s1 = __fadd_rn(s1, power4<kCplx>(v[j + 1]));
  }
  float s = __fadd_rn(s0, s1);
  for (int o = min(sub, 32) >> 1; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  const Layout lay = layout_of(p.n, p.window, kCplx, W, 0, p.chunk, 0);
  float* wp = smem + lay.wp;
  if (mine && (part & 31) == 0) wp[task * W + (part >> 5)] = s;
  __syncthreads();
  const int slots = max(1, sub >> 5);
  auto total = [&](int t) {
    float sum = 0.f;
    for (int w = 0; w < slots; ++w) sum = __fadd_rn(sum, wp[t * W + w]);
    return sum;
  };
  int gate;
  if (nwin == 1) {   // one window: its gate, in every thread
    const float db = to_db(total(0), inv_window_of(p.window));
    const bool above = db > level;   // false for NaN
    h = above ? p.hang_windows : max(h - 1, 0);
    open = above || h > 0;
    gate = open;
    if (tid == 0) p.power_db[row] = db;
  } else {
    float* pdb = smem + lay.pdb + warp * lay.per_warp;
    for (int c = lane; c < nwin; c += 32) {
      const float db = to_db(total(c), inv_window_of(p.window));
      pdb[c] = db;
      if (warp == 0) p.power_db[(size_t)row * nwin + c] = db;
    }
    __syncwarp();
    hang_gates(pdb, nwin, level, p.hang_windows, open, h, lane);
    __syncwarp();
    gate = mine ? reinterpret_cast<const int*>(pdb)[task] : 0;
  }
  if (tid == 0) {
    p.open_out[row] = open ? 1 : 0;
    p.hang_out[row] = h;
  }
  float4* y4 = reinterpret_cast<float4*>(p.y) + at;
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    const int i = part + j * sub;
    if (mine && i < m) y4[i] = gate ? v[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int kCplx, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32) squelch_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bars[kMaxStages];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = p.warps, T = W * 32;
  const int rowf = p.n * kCplx, wf = p.window * kCplx, nwin = p.n / p.window;
  const bool sliced = p.slice > 0;
  const float inv_window = inv_window_of(p.window);

  // the CTA's piece: floats [s0, s0 + len) of row `row`, the whole row in
  // rows mode
  cg::cluster_group cluster = cg::this_cluster();
  int row, rank = 0, s0 = 0, len = rowf;
  if (sliced) {
    rank = (int)cluster.block_rank();
    row = (int)blockIdx.x / p.cluster;
    s0 = rank * p.slice;
    len = min(s0 + p.slice, rowf) - s0;
  } else {
    row = (int)blockIdx.x;
  }
  const Layout lay = layout_of(p.n, p.window, kCplx, W, p.slice, p.chunk, p.stages);
  float* buf = smem;
  float* wp = smem + lay.wp;
  float* acc = smem + lay.acc;
  float* pdb = smem + lay.pdb + warp * lay.per_warp;
  const unsigned bar0 = smem_addr(bars);
  const float* src = p.x + (size_t)row * rowf + s0;
  const int nch = (len + p.chunk - 1) / p.chunk;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(bar0 + 8 * s, kVec ? 1 : T);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (kVec)   // the bulk copies go out before the barrier that publishes the init
      for (int k = 0; k < min(p.stages, nch); ++k)
        stage<kVec>(buf + k * p.chunk, src + k * p.chunk, min(p.chunk, len - k * p.chunk),
                    bar0 + 8 * k, tid, T);
  }
  __syncthreads();
  if (!kVec)
    for (int k = 0; k < min(p.stages, nch); ++k)
      stage<kVec>(buf + k * p.chunk, src + k * p.chunk, min(p.chunk, len - k * p.chunk),
                  bar0 + 8 * k, tid, T);
  // the row's state, read while the copies fly
  const float level = p.level[row * p.level_stride];
  bool open = p.open0[row] != 0;
  int h = p.hang0[row];
  auto put_sum = [&](int t, int w, float sum) { wp[t * W + w] = sum; };

  if (!sliced) {
    // rows mode: chunk by chunk (one when the row fits), the chunk's window
    // sums, then in every warp their powers and gates from the state the
    // last chunk left, and y of the chunk from its stage
    const int tw = p.chunk / wf;
    for (int k = 0; k < nch; ++k) {
      const int s = k % p.stages;
      mbar_wait(bar0 + 8 * s, (k / p.stages) & 1);
      const int clen = min(p.chunk, len - k * p.chunk);
      const int nt = clen / wf;
      float* xs = buf + s * p.chunk;
      window_sums<kCplx>(xs, clen, 0, wf, tid, T, put_sum);
      __syncthreads();
      const int slots = max(1, group_of(nt, T) >> 5);
      auto total = [&](int t) {
        float sum = 0.f;
        for (int w = 0; w < slots; ++w) sum = __fadd_rn(sum, wp[t * W + w]);
        return sum;
      };
      float* db_out = p.power_db + (size_t)row * nwin + (size_t)k * tw;
      float* y = p.y + (size_t)row * rowf + (size_t)k * p.chunk;
      if (nt == 1) {   // one window: its gate, in every thread
        const float db = to_db(total(0), inv_window);
        const bool above = db > level;   // false for NaN
        h = above ? p.hang_windows : max(h - 1, 0);
        open = above || h > 0;
        const int gate = open;
        if (tid == 0) db_out[0] = db;
        gated_store<kVec>(y, xs, clen, 0, wf, &gate, tid, T);
      } else {
        for (int c = lane; c < nt; c += 32) {
          const float db = to_db(total(c), inv_window);
          pdb[c] = db;
          if (warp == 0) db_out[c] = db;
        }
        __syncwarp();
        hang_gates(pdb, nt, level, p.hang_windows, open, h, lane);
        __syncwarp();
        gated_store<kVec>(y, xs, clen, 0, wf, reinterpret_cast<const int*>(pdb), tid, T);
      }
      if (k + 1 < nch) {
        __syncthreads();   // wp, the gates and this stage are free
        if (k + p.stages < nch) {
          const int b = (k + p.stages) * p.chunk;
          stage<kVec>(xs, src + b, min(p.chunk, len - b), bar0 + 8 * s, tid, T);
        }
      }
    }
    if (tid == 0) {
      p.open_out[row] = open ? 1 : 0;
      p.hang_out[row] = h;
    }
    return;
  }

  // slice mode
  const int g0 = s0 / wf;                     // first window the piece touches
  const int nt = (s0 + len - 1) / wf - g0 + 1;
  if (nch > 1)
    for (int t = tid; t < nt; t += T) acc[t] = 0.f;

  // 1. the piece's window sums; a piece longer than the stages hold is
  // streamed through them chunk by chunk into running sums
  for (int k = 0; k < nch; ++k) {
    const int s = k % p.stages;
    mbar_wait(bar0 + 8 * s, (k / p.stages) & 1);
    const int a = s0 + k * p.chunk;
    const int clen = min(p.chunk, len - k * p.chunk);
    float* xs = buf + s * p.chunk;
    window_sums<kCplx>(xs, clen, a - (a / wf) * wf, wf, tid, T, put_sum);
    __syncthreads();
    if (nch > 1) {
      const int tasks = (a - (a / wf) * wf + clen + wf - 1) / wf;
      const int slots = max(1, group_of(tasks, T) >> 5);
      const int t0 = a / wf - g0;
      for (int t = tid; t < tasks; t += T) {
        float sum = acc[t0 + t];
        for (int w = 0; w < slots; ++w) sum = __fadd_rn(sum, wp[t * W + w]);
        acc[t0 + t] = sum;
      }
      __syncthreads();   // acc settled; wp and the buffer are free
      if (k + p.stages < nch) {
        const int b = (k + p.stages) * p.chunk;
        stage<kVec>(xs, src + b, min(p.chunk, len - b), bar0 + 8 * s, tid, T);
      }
    }
  }
  const bool resident = nch <= p.stages;

  // 2. slice mode: the slice's window sums where the cluster can read them
  const int C = p.cluster;
  if (nch == 1) {
    const int slots = max(1, group_of(nt, T) >> 5);
    for (int t = tid; t < nt; t += T) {
      float sum = 0.f;
      for (int w = 0; w < slots; ++w) sum = __fadd_rn(sum, wp[t * W + w]);
      acc[t] = sum;
    }
  }
  cluster_arrive();
  cluster_wait();
  // 3. every warp: the row's powers, the CTAs a window spans in rank order
  // through distributed shared memory (the same bits in every warp of the
  // cluster), and the hang
  for (int c = lane; c < nwin; c += 32) {
    const int r_lo = (c * wf) / p.slice;
    const int r_hi = min(((c + 1) * wf - 1) / p.slice, C - 1);
    float sum = 0.f;
    for (int r = r_lo; r <= r_hi; ++r) {
      const float* pr = r == rank ? acc : cluster.map_shared_rank(acc, r);
      sum = __fadd_rn(sum, pr[c - (r * p.slice) / wf]);
    }
    const float db = to_db(sum, inv_window);
    pdb[c] = db;
    if (warp == 0 && r_lo == rank) p.power_db[(size_t)row * nwin + c] = db;
  }
  __syncwarp();
  cluster_arrive();   // this thread reads no other CTA's memory again
  hang_gates(pdb, nwin, level, p.hang_windows, open, h, lane);
  if (rank == 0 && tid == 0) {
    p.open_out[row] = open ? 1 : 0;
    p.hang_out[row] = h;
  }
  __syncwarp();
  // 4. y of the slice, from the staged slice or (streamed) from x again
  gated_store<kVec>(p.y + (size_t)row * rowf + s0, resident ? buf : src, len,
                    s0 - g0 * wf, wf, reinterpret_cast<const int*>(pdb) + g0, tid, T);
  cluster_wait();   // no CTA leaves while others may read its sums
}

template <int kCplx, bool kVec, int kRegs>
cudaError_t launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  void (*kernel)(Params);
  if constexpr (kRegs > 0) kernel = squelch_regs_kernel<kCplx, kRegs>;
  else kernel = squelch_kernel<kCplx, kVec>;
  static int smem_set[64] = {};   // the shared memory allowed, by device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) smem_set[dev] = smem;
  }
  if (p.cluster == 1) {   // a cluster launch costs more to start
    kernel<<<grid, p.warps * 32, smem, stream>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)p.warps * 32);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The 16-byte vectors a thread holds in registers mode: the least of 4,
// 8 and 16 that covers its share of its window; 0 where the row does not
// fit (a window not of whole vectors, more windows than threads, or
// more than 16 vectors a thread).
int regs_needed(int n, int window, int cplx, int warps) {
  const long long wf = (long long)window * cplx, nwin = n / window, t = 32ll * warps;
  if (wf % 4 != 0 || nwin > t) return 0;
  const long long sub = group_of((int)nwin, (int)t);
  const long long per = (wf / 4 + sub - 1) / sub;
  return per <= 4 ? 4 : per <= 8 ? 8 : per <= 16 ? 16 : 0;
}

// The dynamic shared memory (bytes) a plan takes: ops/squelch.py
// squelch_smem must give the same (a check on the card holds it).
extern "C" long long squelch_smem_bytes(int n, int window, int cplx, int warps, int slice,
                                        int chunk, int stages) {
  return 4 * layout_of(n, window, cplx, warps, slice, chunk, stages).end;
}

// x, y: (rows, n) complex64 (cplx 2) or float32 (cplx 1), n a multiple of
// window; level: (rows,) float32, or one value for every row
// (level_per_row 0); open0, open_out: (rows,) bool as bytes; hang0,
// hang_out: (rows,) int32; power_db: (rows, n / window) float32.  All
// contiguous.  The plan (cluster .. vec) is squelch_plan's: slice 0 is
// rows mode (a CTA a row: stages 0 holds it in registers, chunk the row;
// else in chunks of whole windows), else slice mode (cluster CTAs a
// row); warps a CTA; chunk and stages size the staging ring; vec 1
// stages by bulk copies and stores 16 bytes at a time, 0 by 4-byte
// copies.  The grid and the shared memory follow from the plan.
extern "C" int squelch_launch(const void* x, const void* level,
                              const void* open0, const void* hang0, void* y,
                              void* power_db, void* open_out, void* hang_out,
                              int rows, int n, int window, int cplx,
                              int level_per_row, int hang_windows, int cluster,
                              int warps, int slice, int chunk, int stages, int vec,
                              void* stream) {
  const long long rowf = (long long)n * cplx, wf = (long long)window * cplx;
  if (rows <= 0 || window <= 0 || n <= 0 || n % window != 0 ||
      (cplx != 1 && cplx != 2) || rowf >= (1ll << 31) || warps < 1 || warps > kMaxWarps ||
      stages < 0 || stages > kMaxStages || chunk <= 0 || chunk % cplx != 0 || slice < 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = squelch_smem_bytes(n, window, cplx, warps, slice, chunk, stages);
  if (smem + 8 * kMaxStages > kMaxSmemBytes) return (int)cudaErrorInvalidValue;   // + the mbarriers
  long long grid = rows;
  const int regs = stages == 0 ? regs_needed(n, window, cplx, warps) : 0;
  if (stages == 0 && (slice != 0 || !vec || chunk != rowf || regs == 0))
    return (int)cudaErrorInvalidValue;
  if (slice == 0) {   // rows mode: chunks of whole windows, one for the row or fewer floats
    if (cluster != 1 || chunk % wf != 0 || chunk > rowf) return (int)cudaErrorInvalidValue;
  } else {            // slice mode: y is stored at slice offsets below 2^22 floats
    if ((cluster != 2 && cluster != 4 && cluster != 8) || slice % cplx != 0 ||
        (long long)slice * cluster < rowf || (long long)slice * (cluster - 1) >= rowf ||
        slice + wf >= (1ll << 22))
      return (int)cudaErrorInvalidValue;
    grid = (long long)rows * cluster;
  }
  if (grid >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (vec && (rowf % 4 != 0 || chunk % 4 != 0 || slice % 4 != 0 ||
              reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(y) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  Params p{static_cast<const float*>(x), static_cast<const float*>(level),
           static_cast<const unsigned char*>(open0),
           static_cast<const int*>(hang0), static_cast<float*>(y),
           static_cast<float*>(power_db),
           static_cast<unsigned char*>(open_out), static_cast<int*>(hang_out),
           rows, n, window, level_per_row ? 1 : 0, hang_windows,
           cluster, warps, slice, chunk, stages};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = (int)grid, m = (int)smem;
  if (cplx == 2)
    switch (regs) {
      case 4: return (int)launch<2, true, 4>(p, g, m, s);
      case 8: return (int)launch<2, true, 8>(p, g, m, s);
      case 16: return (int)launch<2, true, 16>(p, g, m, s);
      default: return (int)(vec ? launch<2, true, 0>(p, g, m, s) : launch<2, false, 0>(p, g, m, s));
    }
  switch (regs) {
    case 4: return (int)launch<1, true, 4>(p, g, m, s);
    case 8: return (int)launch<1, true, 8>(p, g, m, s);
    case 16: return (int)launch<1, true, 16>(p, g, m, s);
    default: return (int)(vec ? launch<1, true, 0>(p, g, m, s) : launch<1, false, 0>(p, g, m, s));
  }
}

extern "C" const char* owrx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
