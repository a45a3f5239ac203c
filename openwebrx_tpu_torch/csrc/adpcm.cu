// Stride-parallel IMA ADPCM encode, the whole of adpcm_encode in one launch:
// the reseed states of every (channel, stride) lane, the 200-step nibble
// recurrence of each lane, the packed stride states and the carried state.
//
// Replaces: openwebrx_tpu/ops/adpcm.py adpcm_encode (the STATE_STRIDE-step
// lax.scan over _encode_nibble pairs) with its _estimate_index and the
// reseed bookkeeping around it, which the port's plain version runs as
// about a dozen small launches.  Each lane starts from its reseed state
// (predictor = the raw sample before the stride, step index estimated from
// the stride before it; stride 0 of a channel from the carried state) and
// runs 100 pair-steps, i.e. 200 dependent nibble steps, writing the
// stride's 100 bytes.  The bytes and states must equal the reference bit
// for bit: the browser decoder adopts the reseed states carried in the sync
// headers.  With explicit start states (prev, idxs) the same kernel runs
// the recurrence alone (encode_strides).
//
// What bounds it on the card.  At the 1024-channel bank's shape (1024 x 600
// int16 in, 1024 x 300 bytes out, 3072 lanes) it moves ~1.6 MB (~0.5 us at
// 3.35 TB/s) and issues ~44 instructions a nibble, ~27 M in all (~1.6 us
// at 64 int32 instructions per clock per SM).  What it cannot escape is
// the serial dependence of each lane: 200 nibble steps, each a chain of
// nine dependent instructions through the predictor (difference, abs,
// compare, three predicate combinations, the magnitude, the clamped
// update).  chip_smoke.py measures that chain's time per step: the slope
// between this build and one with ADPCM_STRIDE=52.  3072 lanes are fewer
// than one warp per SM, so nothing hides its latency, and the design's aim
// is to put nothing else on the chain.
//
// Design: one CTA per 32 lanes; warp 0 runs the lanes' recurrences, all
// five warps share the work before them.
//   1. One bulk asynchronous copy (TMA, cp.async.bulk with an mbarrier)
//      stages the CTA's rows, which are contiguous in device memory, plus
//      the row of the lane before the first (its last sample and index
//      estimate seed the first lane).  Lane t's row is 100 words at word
//      100 t: read as 16-byte vectors, the 8 lanes of a quarter warp hit 8
//      distinct 4-bank groups, so the unpadded rows are free of conflicts.
//   2. While the copy flies, the threads build a shared table of the five
//      states each index can move to (index - 1, + 2, + 4, + 6, + 8,
//      clamped to 0..88), packed as (byte offset of that index's row << 16)
//      | step.
//   3. In parallel, four threads per staged row sum its 199 |dx| in int32
//      (exact), and the first divides once by 199 (IEEE) and searches the
//      89-entry table for the left insertion point, as torch.searchsorted
//      does; it also writes the packed stride state and, for a channel's
//      last stride, the carried state.
//   4. Each lane's step compares |diff| against the seven thresholds that
//      the reference's compare-and-subtract stages amount to, all known
//      from the step alone, combines the three magnitude bits as predicate
//      logic (inline PTX: the compiler would otherwise branch), selects its
//      next state from the five candidates of its current index, held in
//      registers, and then loads the candidates of the new index, which
//      have a whole step to arrive: the table read is off the chain.
//      Samples come from shared memory as 16-byte vectors ahead of use;
//      bytes leave as one word per 4 pairs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// bytes per stride, STATE_STRIDE of ops/adpcm.py.  Another stride of
// 4 + 16 k bytes builds the same main loop (unrolled by four words) with
// shorter or longer lanes, to time the recurrence per step
#ifndef ADPCM_STRIDE
#define ADPCM_STRIDE 100
#endif
constexpr int kStride = ADPCM_STRIDE;
static_assert(kStride % 4 == 0, "rows are read as 16-byte vectors");
constexpr int kRowBytes = 4 * kStride;   // 2 kStride int16 samples
constexpr int kRowWords = kStride;
constexpr int kLanes = 32;               // lanes per CTA: warp 0
constexpr int kThreads = 160;            // 4 threads for each of 33 rows
constexpr int kParts = 4;                // threads per row in the estimate
constexpr int kSearch = 128;             // step table padded for the search

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

struct Params {
  const short* x;        // (lanes, 200) int16, channel-major
  const int* pred0;      // (channels,) carried state, or null
  const int* idx0;
  const int* prev;       // (lanes,) explicit start states, or null
  const int* idxs;
  unsigned int* out;     // (lanes, 100) bytes as words
  int* stride_out;       // (lanes,) packed stride states, or null
  int* pred_out;         // (channels,) new carried state, or null
  int* idx_out;
  int lanes;
  int strides;           // strides per channel
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int clamp_index(int i) { return min(max(i, 0), 88); }

// The five states an index can move to (index - 1, + 2, + 4, + 6, + 8),
// each packed as (byte offset of its own row << 16) | step.  Volatile
// loads: the compiler may not turn the fifth into a load predicated on the
// next step's compares, which would put it back on the chain.
struct Next {
  int c0, c2, c4, c6, c8;
};

__device__ __forceinline__ Next load_next(unsigned cand_base, int is) {
  Next n;
  const unsigned row = cand_base + ((unsigned)is >> 16);
  asm volatile("ld.volatile.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(n.c0), "=r"(n.c2), "=r"(n.c4), "=r"(n.c6) : "r"(row));
  asm volatile("ld.volatile.shared.b32 %0, [%1+16];\n" : "=r"(n.c8) : "r"(row));
  return n;
}

// One IMA nibble.  `is` holds the current (row offset << 16) | step and
// `nx` that row, loaded one step ahead: the step selects the next state
// from registers, then loads the next row, which has a whole step to
// arrive.  The three magnitude bits compare |diff| against thresholds known
// from the step alone (the reference's compare-and-subtract stages,
// unrolled), so the chain through the predictor is: difference, abs,
// compare, two predicate selects, the magnitude, the clamped update.
// kFull: clamp on both sides, for a start predictor that may lie outside
// int16; after one step it does not, and one side suffices.
template <bool kFull>
__device__ __forceinline__ int encode_nibble(int& pred, int& is, Next& nx,
                                             int sample, unsigned cand_base) {
  const int step = is & 0xFFFF;
  const int s2 = step >> 1, s4 = step >> 2, s8 = step >> 3;
  const int t2 = step + s2;
  const int diff = sample - pred;
  const bool neg = diff < 0;
  const int ad = abs(diff);
  // b4 = ad >= step; b2 = ad >= (b4 ? t2 : s2); b1 = ad >= s4 + (b4 ? step
  // : 0) + (b2 ? s2 : 0): seven compares at once, then predicate logic, in
  // PTX so that the selects stay predicate operations and do not become
  // branches.  Out: the magnitude, the next (row, step) and the low bits.
  int mag, low;
  asm("{\n\t"
      ".reg .pred p4, p2, p1, n4, n2, a, b, c, d, e, f;\n\t"
      ".reg .b32 ra, rb, rm;\n\t"
      "setp.ge.s32 p4, %3, %4;\n\t"
      "setp.ge.s32 a, %3, %5;\n\t"
      "setp.ge.s32 b, %3, %6;\n\t"
      "setp.ge.s32 c, %3, %7;\n\t"
      "setp.ge.s32 d, %3, %8;\n\t"
      "setp.ge.s32 e, %3, %9;\n\t"
      "setp.ge.s32 f, %3, %10;\n\t"
      "not.pred n4, p4;\n\t"
      "and.pred b, b, p4;\n\t"          // p2 = p4 ? b : a
      "and.pred a, a, n4;\n\t"
      "or.pred p2, a, b;\n\t"
      "and.pred e, e, p4;\n\t"          // c = p4 ? e : c (b2 clear)
      "and.pred c, c, n4;\n\t"
      "or.pred c, c, e;\n\t"
      "and.pred f, f, p4;\n\t"          // d = p4 ? f : d (b2 set)
      "and.pred d, d, n4;\n\t"
      "or.pred d, d, f;\n\t"
      "not.pred n2, p2;\n\t"
      "and.pred d, d, p2;\n\t"          // p1 = p2 ? d : c
      "and.pred c, c, n2;\n\t"
      "or.pred p1, c, d;\n\t"
      "selp.b32 ra, %4, 0, p4;\n\t"     // magnitude
      "selp.b32 rb, %5, 0, p2;\n\t"
      "add.s32 rm, %11, ra;\n\t"
      "add.s32 rm, rm, rb;\n\t"
      "add.s32 rb, rm, %7;\n\t"
      "selp.b32 %0, rb, rm, p1;\n\t"
      "selp.b32 ra, %15, %13, p2;\n\t"  // next (row, step): low nibble
      "selp.b32 ra, ra, %12, p4;\n\t"   // < 4: index - 1; 4, 5, 6, 7:
      "selp.b32 rb, %16, %14, p2;\n\t"  // index + 2, 4, 6, 8
      "selp.b32 rb, rb, %12, p4;\n\t"
      "selp.b32 %1, rb, ra, p1;\n\t"
      "selp.b32 ra, 4, 0, p4;\n\t"      // low three nibble bits
      "selp.b32 rb, 2, 0, p2;\n\t"
      "or.b32 ra, ra, rb;\n\t"
      "selp.b32 rb, 1, 0, p1;\n\t"
      "or.b32 %2, ra, rb;\n\t"
      "}"
      : "=&r"(mag), "=&r"(is), "=&r"(low)
      : "r"(ad), "r"(step), "r"(s2), "r"(t2), "r"(s4), "r"(s2 + s4),
        "r"(step + s4), "r"(t2 + s4), "r"(s8), "r"(nx.c0), "r"(nx.c2),
        "r"(nx.c4), "r"(nx.c6), "r"(nx.c8));
  nx = load_next(cand_base, is);
  if (kFull)
    pred = min(max(neg ? pred - mag : pred + mag, -32768), 32767);
  else
    pred = neg ? max(pred - mag, -32768) : min(pred + mag, 32767);
  return (neg ? 8 : 0) | low;
}

// Eight samples (one 16-byte vector) to four bytes, low nibble first.
template <bool kFirst>
__device__ __forceinline__ unsigned encode_word(int& pred, int& is, Next& nx,
                                                uint4 v, unsigned cand_base) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
  unsigned out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int first = (int)(short)(words[k] & 0xFFFFu);   // little-endian
    const int second = (int)words[k] >> 16;               // arithmetic
    const int lo = (kFirst && k == 0)
        ? encode_nibble<true>(pred, is, nx, first, cand_base)
        : encode_nibble<false>(pred, is, nx, first, cand_base);
    const int hi = encode_nibble<false>(pred, is, nx, second, cand_base);
    out |= (unsigned)(lo | (hi << 4)) << (8 * k);
  }
  return out;
}

__global__ void __launch_bounds__(kThreads) adpcm_kernel(Params p) {
  __shared__ __align__(128) unsigned int rows[(kLanes + 1) * kRowWords];
  __shared__ __align__(16) int cand[89 * 8];
  __shared__ float search[kSearch];
  __shared__ int est[kLanes + 1];
  __shared__ __align__(8) unsigned long long bar;

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * kLanes;
  const int nl = min(kLanes, p.lanes - l0);
  const bool fused = p.prev == nullptr;
  const int first = (fused && l0 > 0) ? l0 - 1 : l0;   // first staged lane
  const int nrows = l0 + nl - first;
  const unsigned bar_addr = smem_addr(&bar);

  // 1. one bulk copy of the CTA's rows
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const unsigned bytes = (unsigned)(nrows * kRowBytes);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar_addr), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(rows)), "l"(p.x + (size_t)first * 2 * kStride),
        "r"(bytes), "r"(bar_addr)
        : "memory");
  }

  // 2. while it flies: the candidate table and the search table
  for (int k = tid; k < 89 * 5; k += kThreads) {
    const int i = k / 5, m = k - 5 * (k / 5);
    const int j = clamp_index(i + (m == 0 ? -1 : 2 * m));
    cand[i * 8 + m] = (j * 32) << 16 | kStepTable[j];   // row j at byte 32 j
  }
  for (int k = tid; k < kSearch; k += kThreads)
    search[k] = k < 89 ? (float)kStepTable[k] : __int_as_float(0x7f800000);
  // the lane's start state when it comes from device memory
  int pred = 0, idx = 0;
  const int lane = l0 + tid;
  const bool chain = tid < nl;
  const int s = chain ? lane % p.strides : 0;
  if (chain) {
    if (!fused) {
      pred = p.prev[lane];
      idx = p.idxs[lane];
    } else if (s == 0) {
      pred = p.pred0[lane / p.strides];
      idx = p.idx0[lane / p.strides];
    }
  }
  __syncthreads();   // the barrier's init is visible to every waiter
  {
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n.reg .pred q;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 q, [%1], 0;\n"
          "selp.u32 %0, 1, 0, q;\n}\n"
          : "=r"(done)
          : "r"(bar_addr)
          : "memory");
    }
  }

  // 3. the index estimates: 4 threads per staged row, exact int32 sums
  if (fused) {
    static_assert((kLanes + 1) * kParts <= kThreads, "one pass over the rows");
    const short* xs = reinterpret_cast<const short*>(rows);
    {
      // every thread reaches the shuffles; the four parts of a row are
      // neighbouring threads of one warp
      const int r = tid / kParts, part = tid % kParts;
      int total = 0;
      if (r < nrows) {
        const short* xr = xs + r * 2 * kStride;
        const int i0 = part * (2 * kStride / kParts);
        int last = part ? xr[i0 - 1] : xr[0];
        for (int i = i0; i < i0 + 2 * kStride / kParts; ++i) {
          const int v = xr[i];
          total += abs(v - last);
          last = v;
        }
      }
      total += __shfl_xor_sync(0xffffffffu, total, 1);
      total += __shfl_xor_sync(0xffffffffu, total, 2);
      if (r < nrows && part == 0) {
        const float md = __fdiv_rn((float)total, (float)(2 * kStride - 1));
        int pos = 0;                     // entries below md: the left insert
#pragma unroll
        for (int w = kSearch / 2; w > 0; w >>= 1)
          if (search[pos + w - 1] < md) pos += w;
        const int e = min(pos, 88);
        est[r] = e;
        const int lr = first + r;        // the row's lane
        if (lr >= l0) {
          const int last = xs[r * 2 * kStride + 2 * kStride - 1];
          p.stride_out[lr] = (int)(((unsigned)last & 0xFFFFu) << 16 | (unsigned)e);
          if (lr % p.strides == p.strides - 1) {
            p.pred_out[lr / p.strides] = last;
            p.idx_out[lr / p.strides] = e;
          }
        }
      }
    }
    __syncthreads();
  }

  // 4. the recurrences, one thread per lane
  if (!chain) return;
  const int r = lane - first;            // staged row of this lane
  if (fused && s > 0) {
    pred = reinterpret_cast<const short*>(rows)[r * 2 * kStride - 1];
    idx = est[r - 1];
  }
  idx = clamp_index(idx);
  int is = (idx * 32) << 16 | kStepTable[idx];
  const unsigned cand_base = smem_addr(cand);
  Next nx = load_next(cand_base, is);
  const uint4* src = reinterpret_cast<const uint4*>(rows + r * kRowWords);
  unsigned int* dst = p.out + (size_t)lane * (kStride / 4);
  dst[0] = encode_word<true>(pred, is, nx, src[0], cand_base);
#pragma unroll 4
  for (int w = 1; w < kStride / 4; ++w)
    dst[w] = encode_word<false>(pred, is, nx, src[w], cand_base);
}

}  // namespace

// samples: (lanes, 2*kStride) int16, 16-byte aligned, channel-major with
// `strides` lanes per channel; out: (lanes, kStride) uint8.  Fused mode
// (prev == idxs == null): pred0, idx0 (channels,) int32 carried state;
// stride_out (lanes,), pred_out, idx_out (channels,) int32 outputs.
// Explicit mode: prev, idxs (lanes,) int32 start states; pred0, idx0 and
// the three outputs unused.  All contiguous.
extern "C" int adpcm_launch(const void* samples, const void* pred0,
                            const void* idx0, const void* prev,
                            const void* idxs, void* out, void* stride_out,
                            void* pred_out, void* idx_out, int lanes,
                            int strides, void* stream) {
  const bool fused = prev == nullptr;
  if (lanes <= 0 || strides <= 0 || (fused && lanes % strides != 0) ||
      reinterpret_cast<uintptr_t>(samples) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0 || (idxs == nullptr) != fused ||
      (fused && (!pred0 || !idx0 || !stride_out || !pred_out || !idx_out)))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const short*>(samples), static_cast<const int*>(pred0),
           static_cast<const int*>(idx0), static_cast<const int*>(prev),
           static_cast<const int*>(idxs), static_cast<unsigned int*>(out),
           static_cast<int*>(stride_out), static_cast<int*>(pred_out),
           static_cast<int*>(idx_out), lanes, fused ? strides : 1};
  const int blocks = (lanes + kLanes - 1) / kLanes;
  adpcm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* owrx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
