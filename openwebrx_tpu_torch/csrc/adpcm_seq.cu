// Exact continuous IMA ADPCM encode, the whole of adpcm_encode_seq in one
// launch: every row is one unbroken nibble recurrence from its start state,
// with the packed codec state after every 100th byte and the final state.
//
// Replaces: openwebrx_tpu/ops/adpcm.py adpcm_encode_seq (a lax.scan of
// _encode_nibble pairs over the whole row), which the port's plain version
// runs as a Python loop of ~30 small launches a byte.  The waterfall
// compresses its rows with it (WaterfallStage compress=True): dB x 100 as
// int16, 10 pad samples in front, padded to a multiple of 8 samples, a fresh
// codec per row.  The browser decodes a whole row from a fresh codec, so
// nothing may reseed inside a row: bytes, stride states and final state
// must equal the reference bit for bit.
//
// What bounds it on the card: the serial chain.  A waterfall block gives one
// row, 4112 nibbles at fft_size 4096, and each nibble depends on the one
// before through the predictor and the step index.  The bytes (8 KB in,
// 2 KB out) take ~3 ns at 3.35 TB/s; the chain, at the ~107 cycles a nibble
// that csrc/adpcm.cu's identical step measures, ~0.22 ms.  chip_smoke.py
// measures this kernel's own time per nibble as the slope between rows of
// 2064 and 4112 samples (the row length is a runtime argument).  With one
// row there is one active lane, so the design's aim is that nothing but the
// recurrence sits on the chain.
//
// Design: a CTA owns up to 32 rows (one lane of warp 0 each; more rows per
// CTA cost the chain nothing, the lanes run in lockstep) and:
//   1. stages its rows in shared memory with 16-byte cp.async (2-byte loads
//      when a row is not a multiple of 8 samples), so the chain reads its
//      samples from shared memory as 16-byte vectors ahead of use;
//   2. builds, while the copy flies, a shared table of the five states each
//      step index can move to (index - 1, + 2, + 4, + 6, + 8, clamped to
//      0..88), packed as (byte offset of that index's row << 16) | step;
//   3. runs each row's recurrence with the nibble step of csrc/adpcm.cu
//      (copied, not shared: that file's SASS main loop is checked as it
//      is): seven compares against thresholds known from the step alone,
//      predicate logic in inline PTX, the next state selected from the
//      candidates of the current index held in registers, and the next
//      candidates loaded a whole step ahead, so the table read is off the
//      chain.  The packed state after every 25th word (100 bytes) is stored
//      as the chain passes it;
//   4. writes the bytes through shared memory: the chain leaves words in a
//      shared buffer, and after it all threads copy them out with
//      coalesced stores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRowsPerCta = 32;       // the chains fit in warp 0
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kStrideWords = 25;         // STATE_STRIDE = 100 bytes

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
  const short* x;          // (rows, ns) int16
  const int* pred0;        // (rows,) start state
  const int* idx0;
  unsigned char* out;      // (rows, ns / 2) bytes
  int* stride_out;         // (rows, ns / 200) packed states
  int* pred_out;           // (rows,) final state
  int* idx_out;
  int rows, ns;
  int rows_per_cta;
  int ld;                  // staged row stride, samples (a multiple of 8)
  int ow;                  // staged output row stride, words
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int clamp_index(int i) { return min(max(i, 0), 88); }

// a / b for 0 <= a < 2^22: a float estimate corrected by one step
__device__ __forceinline__ int div_small(int a, int b, float inv_b) {
  int q = __float2int_rz(__int2float_rn(a) * inv_b);
  if (q * b > a) --q;
  else if ((q + 1) * b <= a) ++q;
  return q;
}

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

// One IMA nibble, as in csrc/adpcm.cu.  `is` holds the current (row offset
// << 16) | step and `nx` that row, loaded one step ahead.  kFull: clamp on
// both sides, for a start predictor that may lie outside int16; after one
// step it does not, and one side suffices.
template <bool kFull>
__device__ __forceinline__ int encode_nibble(int& pred, int& is, Next& nx,
                                             int sample, unsigned cand_base) {
  const int step = is & 0xFFFF;
  const int s2 = step >> 1, s4 = step >> 2, s8 = step >> 3;
  const int t2 = step + s2;
  const int diff = sample - pred;
  const bool neg = diff < 0;
  const int ad = abs(diff);
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

__device__ __forceinline__ int packed_state(int pred, int is) {
  // the index of row offset (32 idx) << 16 is is >> 21
  return (int)(((unsigned)pred << 16) | ((unsigned)is >> 21));
}

__global__ void __launch_bounds__(kThreads) adpcm_seq_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) int cand[89 * 8];
  const int ns = p.ns;
  const int nbytes = ns >> 1;
  const int ld = p.ld, ow = p.ow;
  short* xs = reinterpret_cast<short*>(smem);                     // [rpc][ld]
  unsigned* os = reinterpret_cast<unsigned*>(xs + p.rows_per_cta * ld);   // [rpc][ow]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * p.rows_per_cta;
  const int nr = min(p.rows_per_cta, p.rows - row0);
  const short* xg = p.x + (size_t)row0 * ns;

  // 1. stage the rows; 2. the candidate table while the copy flies
  if (ns % 8 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0) {
    const int q = ns >> 3;                 // 16-byte vectors a row
    const float inv_q = 1.f / (float)q;
    for (int k = tid; k < nr * q; k += kThreads) {
      const int r = div_small(k, q, inv_q);
      const int i = (k - r * q) << 3;
      cp_async16(xs + r * ld + i, xg + (size_t)r * ns + i);
    }
  } else {
    for (int r = 0; r < nr; ++r)
      for (int i = tid; i < ns; i += kThreads) xs[r * ld + i] = xg[(size_t)r * ns + i];
  }
  for (int k = tid; k < 89 * 5; k += kThreads) {
    const int i = k / 5, m = k - 5 * (k / 5);
    const int j = clamp_index(i + (m == 0 ? -1 : 2 * m));
    cand[i * 8 + m] = (j * 32) << 16 | kStepTable[j];   // row j at byte 32 j
  }
  int pred = 0, idx = 0;
  if (tid < nr) {
    pred = p.pred0[row0 + tid];
    idx = clamp_index(p.idx0[row0 + tid]);
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. the recurrences, one lane per row
  if (tid < nr) {
    const int row = row0 + tid;
    int is = (idx * 32) << 16 | kStepTable[idx];
    const unsigned cand_base = smem_addr(cand);
    Next nx = load_next(cand_base, is);
    const short* xr = xs + tid * ld;
    const uint4* src = reinterpret_cast<const uint4*>(xr);
    unsigned* dst = os + tid * ow;
    int* st = p.stride_out + (size_t)row * (nbytes / 100);
    const int words = ns >> 3;
    int w = 0;
    if (words > 0) {
      dst[0] = encode_word<true>(pred, is, nx, src[0], cand_base);
      w = 1;
    }
    int until_stride = kStrideWords - w;
#pragma unroll 4
    for (; w < words; ++w) {
      if (until_stride == 0) {             // the state after 100 bytes
        *st++ = packed_state(pred, is);
        until_stride = kStrideWords;
      }
      dst[w] = encode_word<false>(pred, is, nx, src[w], cand_base);
      --until_stride;
    }
    if (until_stride == 0 && words > 0) *st = packed_state(pred, is);
    // the last 2, 4 or 6 samples of a row that is not a multiple of 8:
    // never a stride boundary (100 bytes are 25 whole words)
    unsigned char* tail = reinterpret_cast<unsigned char*>(dst + words);
    for (int i = words * 8; i + 1 < ns; i += 2) {
      const int lo = i == 0 ? encode_nibble<true>(pred, is, nx, xr[i], cand_base)
                            : encode_nibble<false>(pred, is, nx, xr[i], cand_base);
      const int hi = encode_nibble<false>(pred, is, nx, xr[i + 1], cand_base);
      tail[(i - words * 8) >> 1] = (unsigned char)(lo | (hi << 4));
    }
    p.pred_out[row] = pred;
    p.idx_out[row] = (int)((unsigned)is >> 21);
  }
  __syncthreads();

  // 4. the bytes out, coalesced
  unsigned char* og = p.out + (size_t)row0 * nbytes;
  if (nbytes % 4 == 0 && reinterpret_cast<uintptr_t>(p.out) % 4 == 0) {
    // staged rows are contiguous when a row is whole words (ow == nbytes / 4)
    unsigned* o32 = reinterpret_cast<unsigned*>(og);
    for (int k = tid; k < nr * ow; k += kThreads) o32[k] = os[k];
  } else {
    const unsigned char* ob = reinterpret_cast<const unsigned char*>(os);
    const float inv_n = 1.f / (float)nbytes;
    for (int k = tid; k < nr * nbytes; k += kThreads) {
      const int r = div_small(k, nbytes, inv_n);
      og[k] = ob[r * ow * 4 + (k - r * nbytes)];
    }
  }
}

}  // namespace

// samples: (rows, ns) int16, ns even; pred0, idx0: (rows,) int32 start
// states (index 0..88); out: (rows, ns / 2) uint8; stride_out: (rows,
// ns / 200) int32, the packed state after every 100th byte; pred_out,
// idx_out: (rows,) int32.  All contiguous.
extern "C" int adpcm_seq_launch(const void* samples, const void* pred0,
                                const void* idx0, void* out, void* stride_out,
                                void* pred_out, void* idx_out, int rows,
                                int ns, void* stream) {
  if (rows <= 0 || ns <= 0 || ns % 2 != 0) return (int)cudaErrorInvalidValue;
  const int ld = (ns + 7) & ~7;
  const int ow = (ns / 2 + 3) / 4;
  const size_t row_bytes = (size_t)ld * 2 + (size_t)ow * 4;
  const size_t budget = kMaxSmemBytes - 89 * 8 * sizeof(int);
  if (row_bytes > budget) return (int)cudaErrorInvalidValue;
  int rpc = rows < kMaxRowsPerCta ? rows : kMaxRowsPerCta;
  if ((size_t)rpc * row_bytes > budget) rpc = (int)(budget / row_bytes);
  const size_t smem = (size_t)rpc * row_bytes;
  if (smem > 48 * 1024 - 89 * 8 * sizeof(int)) {
    const cudaError_t e = cudaFuncSetAttribute(
        adpcm_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Params p{static_cast<const short*>(samples), static_cast<const int*>(pred0),
           static_cast<const int*>(idx0), static_cast<unsigned char*>(out),
           static_cast<int*>(stride_out), static_cast<int*>(pred_out),
           static_cast<int*>(idx_out), rows, ns, rpc, ld, ow};
  const int blocks = (rows + rpc - 1) / rpc;
  adpcm_seq_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* owrx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
