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
// 2 KB out) take ~3 ns at 3.35 TB/s; one lane walking the row at the ~100
// cycles a nibble of the nibble step below (nine dependent instructions)
// takes ~0.2 ms, with every other lane and SM idle.  The step has no slack
// left, so the design shortens the chain: it walks far fewer nibbles in
// series than the row has.
//
// Design: candidate runs and one sweep, exact by construction.  IMA is a
// closed loop: two encoders fed the same samples from different states tend
// to reach the identical state (the index clamps at 0 and 88, the predictor
// tracks the input), and from there every nibble is equal.  A CTA owns one
// row, cut into K segments of whole 16-byte words (8 nibbles):
//   1. the row is staged in shared memory with 16-byte cp.async (2-byte
//      loads when a row is not a multiple of 8 samples);
//   2. every segment k >= 1 gets a guessed start state: the sample before
//      it as the predictor, and the index whose step first reaches the mean
//      |dx| of segment k - 1 (the audio encoder's reseed rule) plus 2 (the
//      rule guesses low on waterfall rows).  Segment 0 starts from the true
//      state;
//   3. pass 1: thread k runs from its start through segments k .. k + E - 1,
//      all threads in lockstep, storing each word's bytes, and the state
//      before a segment's first word, as candidate slot e of segment k + e.
//      So segment k holds up to E candidates, warmed up over 0 .. E - 1
//      segments before it;
//   4. the sweep: one warp walks the segments with the true state.  At a
//      segment start it looks for a slot whose stored state is the truth's
//      (a lane a slot, one ballot) and takes the most recently started run
//      that holds it; that run's slots are one trajectory, so the sweep
//      follows it to its end with no work and looks again there.  Where no
//      slot holds the truth it encodes the segments itself, in bursts that
//      double while no run joins;
//   5. each segment's chosen candidate words go into the output, the stride
//      states are read from the stored states, and the bytes go out through
//      shared memory with coalesced stores.
// The serial chain is one run of pass 1 (E segments) plus what the sweep
// encodes itself.  With K = 128 and E = 10 a 4112-nibble row is a first
// pass of 328 nibbles, and waterfall rows leave the sweep ~20 run ends to
// look up and few or no words to encode.  The worst case (no run ever joins
// the truth after the first) is pass 1 and then the rest of the row
// encoded by the sweep in ~7 bursts.
//
// The nibble step is csrc/adpcm.cu's (copied, not shared: that file's SASS
// main loop is checked as it is): seven compares against thresholds known
// from the step alone, predicate logic in inline PTX, the next state
// selected from candidates held in registers and loaded a whole step ahead.
// With 128 lanes in lockstep those loads must not collide in shared memory:
// the table of next states is laid out once per lane of a quarter warp (the
// four-candidate vector) and once per lane of the warp (the fifth), so every
// lane reads its own bank whatever index it is at.
//
// Test inputs (the output is the same, only the work differs): `forced` 1
// starts every guessed segment from (-32768, 88); 2 lets the sweep take no
// guessed run, so it encodes all but the first run itself (the worst case).
// `diag`, when given, receives per row: the run ends the sweep looked up,
// the nibbles it encoded itself, the nibbles of the longest pass-1 run, and
// the SM clock cycles of the whole kernel and of its set-up, pass 1, sweep
// and output.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

#ifndef ADPCM_SEQ_SEGMENTS
#define ADPCM_SEQ_SEGMENTS 128
#endif
#ifndef ADPCM_SEQ_SPAN
#define ADPCM_SEQ_SPAN 10
#endif
constexpr int kSegments = ADPCM_SEQ_SEGMENTS;   // K: one thread each
constexpr int kSpan = ADPCM_SEQ_SPAN;           // E: segments a run covers
constexpr int kThreads = kSegments > 128 ? (kSegments + 31) / 32 * 32 : 128;
static_assert(kSegments >= 1 && kSegments <= 1024 && kSpan >= 1, "segments, span");
static_assert(kSpan <= 32, "the sweep checks a candidate a lane");
constexpr int kGuessOffset = 2;          // the reseed rule guesses low on waterfall rows
constexpr int kUnroll = 2;               // words a turn of the word loop (1 and 4
                                         // were slower on the card)
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kStrideWords = 25;         // STATE_STRIDE = 100 bytes
constexpr int kNone = -1;                // no candidate: never a packed state
constexpr int kDiag = 8;                 // diag words a row
constexpr int kRowBytes = 128;           // table bytes an index
constexpr unsigned kAllLanes = 0xffffffffu;

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
  int* diag;               // (rows, kDiag); may be null
  int rows, ns;
  int ld;                  // staged row length, samples (a multiple of 8)
  int span;                // segments a run covers (<= kSpan, as shared memory allows)
  int forced;              // test input: 1 guesses (-32768, 88), 2 no candidate
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

// A lane's view of the next-state table: `is` holds (index * kRowBytes)
// << 16 | step, and the five states an index can move to (index - 1, + 2,
// + 4, + 6, + 8, packed the same way) sit at that byte offset in two
// tables: the first four as one vector in the lane's copy of the quarter
// warp's eight, the fifth in the lane's copy of the warp's 32.
struct Table {
  unsigned base4, base8;
};

struct Next {
  int c0, c2, c4, c6, c8;
};

// Volatile loads: the compiler may not turn the fifth into a load
// predicated on the next step's compares, which would put it back on the
// chain.
__device__ __forceinline__ Next load_next(const Table& t, int is) {
  Next n;
  const unsigned row = (unsigned)is >> 16;
  asm volatile("ld.volatile.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(n.c0), "=r"(n.c2), "=r"(n.c4), "=r"(n.c6) : "r"(t.base4 + row));
  asm volatile("ld.volatile.shared.b32 %0, [%1];\n" : "=r"(n.c8) : "r"(t.base8 + row));
  return n;
}

// One IMA nibble, as in csrc/adpcm.cu.  `is` holds the current state and
// `nx` its next states, loaded one step ahead.  kFull: clamp on both sides,
// for a start predictor that may lie outside int16; after one step it does
// not, and one side suffices.
template <bool kFull>
__device__ __forceinline__ int encode_nibble(int& pred, int& is, Next& nx,
                                             int sample, const Table& t) {
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
      "selp.b32 ra, %15, %13, p2;\n\t"  // next state: low nibble
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
  nx = load_next(t, is);
  if (kFull)
    pred = min(max(neg ? pred - mag : pred + mag, -32768), 32767);
  else
    pred = neg ? max(pred - mag, -32768) : min(pred + mag, 32767);
  return (neg ? 8 : 0) | low;
}

// Eight samples (one 16-byte vector) to four bytes, low nibble first.
template <bool kFirst>
__device__ __forceinline__ unsigned encode_word(int& pred, int& is, Next& nx,
                                                uint4 v, const Table& t) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
  unsigned out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int first = (int)(short)(words[k] & 0xFFFFu);   // little-endian
    const int second = (int)words[k] >> 16;               // arithmetic
    const int lo = (kFirst && k == 0) ? encode_nibble<true>(pred, is, nx, first, t)
                                      : encode_nibble<false>(pred, is, nx, first, t);
    const int hi = encode_nibble<false>(pred, is, nx, second, t);
    out |= (unsigned)(lo | (hi << 4)) << (8 * k);
  }
  return out;
}

// The last 0, 2, 4 or 6 samples of the row (position `words`, never a
// stride boundary: 100 bytes are 25 whole words) as one word of bytes.
template <bool kFirst>
__device__ __forceinline__ unsigned encode_tail(int words, int ntail, int& pred,
                                                int& is, Next& nx, const short* xs,
                                                const Table& t) {
  unsigned out = 0;
  for (int i = 0; i < ntail; i += 2) {
    const int j = words * 8 + i;
    const int lo = (kFirst && i == 0) ? encode_nibble<true>(pred, is, nx, xs[j], t)
                                      : encode_nibble<false>(pred, is, nx, xs[j], t);
    const int hi = encode_nibble<false>(pred, is, nx, xs[j + 1], t);
    out |= (unsigned)(lo | (hi << 4)) << (4 * i);
  }
  return out;
}

__device__ __forceinline__ int packed_state(int pred, int is) {
  // (index * kRowBytes) << 16 is index << 23
  return (int)(((unsigned)pred << 16) | ((unsigned)is >> 23));
}

// The packed state of index clamp(j): (index * kRowBytes) << 16 | step
__device__ __forceinline__ int next_state(int j) {
  j = clamp_index(j);
  return (j * kRowBytes) << 16 | kStepTable[j];
}

__device__ __forceinline__ int state_is(int idx, const int* steps) {
  return (idx * kRowBytes) << 16 | steps[idx];
}

// Words [w, w_end) (w < w_end <= words) from the state (pred, is, nx):
// their bytes into by[w]; the state before a word into st[w] only where it
// is read later: at the run's first word (a segment start, which the sweep
// checks) and before every 25th word (the stride states)
__device__ __forceinline__ void encode_run(const uint4* src, int w, int w_end, int* st,
                                           unsigned* by, int& pred, int& is, Next& nx,
                                           const Table& tab) {
  st[w] = packed_state(pred, is);
  int until = (kStrideWords - w % kStrideWords) % kStrideWords;
#pragma unroll kUnroll
  for (; w < w_end; ++w) {
    if (until == 0) {
      st[w] = packed_state(pred, is);
      until = kStrideWords;
    }
    by[w] = encode_word<false>(pred, is, nx, src[w], tab);
    --until;
  }
}

__global__ void __launch_bounds__(kThreads) adpcm_seq_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) uint4 cand4[89][8];
  __shared__ __align__(16) int cand8[89][32];
  __shared__ int steps[89];
  __shared__ int seg_b[kSegments + 1];      // segment k: positions [seg_b[k], seg_b[k+1])
  __shared__ int cand_end[kSpan][kSegments];
  __shared__ int sel_slot[kSegments];        // each segment's candidate, or none
  __shared__ int longest_run;
  const long long t_start = clock64();
  const int ns = p.ns;
  const int nbytes = ns >> 1;
  const int words = ns >> 3, ntail = ns & 7;
  const int np = words + 1;                 // positions: the words, then the tail
  const int span = p.span;
  short* xs = reinterpret_cast<short*>(smem);                       // [ld]
  unsigned* os = reinterpret_cast<unsigned*>(smem + 2 * p.ld);      // [np] bytes
  int* st = reinterpret_cast<int*>(os + np);                        // [np] states
  int* cst = st + np;                                               // [span][np]
  unsigned* cby = reinterpret_cast<unsigned*>(cst + span * np);     // [span][np]
  int* dsum = st;           // before the sweep: each word's sum of |dx|
  const uint4* src = reinterpret_cast<const uint4*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x;
  const short* xg = p.x + (size_t)row * ns;
  const int nseg = max(1, min(kSegments, words));

  // 1. stage the row; while it flies, the step table, the segment bounds
  // and the lane copies of the next-state table (a warp's 32 entries share
  // their index, so the constant reads do not diverge)
  if (ns % 8 == 0 && reinterpret_cast<uintptr_t>(xg) % 16 == 0) {
    for (int i = tid * 8; i < ns; i += kThreads * 8) cp_async16(xs + i, xg + i);
  } else {
    for (int i = tid; i < ns; i += kThreads) xs[i] = xg[i];
  }
  for (int i = tid; i < 89; i += kThreads) steps[i] = kStepTable[i];
  for (int k = tid; k <= nseg; k += kThreads) seg_b[k] = k < nseg ? k * words / nseg : np;
  if (tid == 0) longest_run = 0;
  for (int i = tid; i < 89 * 32; i += kThreads) cand8[i >> 5][i & 31] = next_state((i >> 5) + 8);
  for (int i = tid; i < 89 * 8; i += kThreads) {
    const int idx = i >> 3;
    cand4[idx][i & 7] = make_uint4(next_state(idx - 1), next_state(idx + 2),
                                   next_state(idx + 4), next_state(idx + 6));
  }
  cp_async_wait_all();
  __syncthreads();
  // 2. every word's sum of |dx| over its eight samples (the difference into
  // its first one included)
  for (int w = tid; w < words; w += kThreads) {
    const uint4 v = src[w];
    const unsigned h[4] = {v.x, v.y, v.z, v.w};
    int prev = w > 0 ? xs[8 * w - 1] : (int)(short)(h[0] & 0xFFFFu);
    int total = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lo = (int)(short)(h[q] & 0xFFFFu), hi = (int)h[q] >> 16;
      total += abs(lo - prev) + abs(hi - lo);
      prev = hi;
    }
    dsum[w] = total;
  }
  __syncthreads();
  const long long t_setup = clock64();
  const Table tab{smem_addr(&cand4[0][lane & 7]), smem_addr(&cand8[0][lane])};

  // 3. pass 1: thread k from its start through segments k .. k + span - 1,
  // then the row's tail if the run reaches it; slot e of segment k + e.  A
  // guess: the sample before the segment, and the count of table steps
  // that times the differences of segment k - 1 stay below their sum, plus
  // kGuessOffset
  {
    const int k = tid;
    if (k < nseg) {
      int pred, idx;
      if (k == 0) {
        pred = p.pred0[row];
        idx = clamp_index(p.idx0[row]);
      } else if (p.forced == 1) {
        pred = -32768;
        idx = 88;
      } else {
        const int a = seg_b[k - 1], b = seg_b[k];
        int total = 0;
        for (int w = a; w < b; ++w) total += dsum[w];
        const long long nd = 8LL * (b - a) - (a == 0);
        int below = 0;
        for (int half = 64; half > 0; half >>= 1)
          if (below + half <= 89 && (long long)steps[below + half - 1] * nd < total)
            below += half;
        pred = xs[8 * b - 1];
        idx = min(below + kGuessOffset, 88);
      }
      int is = state_is(idx, steps);
      Next nx = load_next(tab, is);
      const int k_end = min(k + span, nseg);            // segments k .. k_end - 1
      int w = seg_b[k];
      for (int seg = k, slot = 0; seg < k_end; ++seg, ++slot) {
        const int wb = seg_b[seg + 1], wb_words = min(wb, words);
        int* cs = cst + slot * np;
        unsigned* cb = cby + slot * np;
        if (seg == k && w < wb_words) {       // both-sided clamp on the first nibble
          cs[w] = packed_state(pred, is);
          cb[w] = encode_word<true>(pred, is, nx, src[w], tab);
          ++w;
        }
        if (w < wb_words) encode_run(src, w, wb_words, cs, cb, pred, is, nx, tab);
        w = wb_words;
        if (wb == np) {                       // the tail: the last segment's
          cs[words] = packed_state(pred, is);
          cb[words] = words == 0
              ? encode_tail<true>(words, ntail, pred, is, nx, xs, tab)
              : encode_tail<false>(words, ntail, pred, is, nx, xs, tab);
        }
        cand_end[slot][seg] = packed_state(pred, is);
      }
      const int w_end = seg_b[k_end];
      atomicMax(&longest_run, 8 * (min(w_end, words) - seg_b[k]) + (w_end == np ? ntail : 0));
    }
  }
  __syncthreads();
  const long long t_pass1 = clock64();

  // 4. the sweep: warp 0 walks the segments with the truth's state, every
  // lane alike.  `truth` is its packed state at the current segment's
  // start; pred/is/nx hold it unpacked while the sweep encodes (`live`).
  // At a segment start lane e checks slot e, the run that began e segments
  // before (it exists when e <= k); forced == 2 leaves only the true
  // start's run (e == k).  Where no slot holds the truth the sweep encodes
  // `burst` segments in one run before it checks again, doubling `burst`
  // while none does: a row no run joins costs a few checks, not one a
  // segment
  if (warp == 0) {
    int pred = p.pred0[row];
    int is = state_is(clamp_index(p.idx0[row]), steps);
    Next nx = load_next(tab, is);
    int truth = packed_state(pred, is);
    bool live = true;
    int hops = 0, encoded = 0, burst = 1;
    for (int k = 0; k < nseg;) {
      const bool valid = lane < min(span, k + 1) && (p.forced != 2 || lane == k);
      const unsigned ballot =
          __ballot_sync(kAllLanes, valid && cst[lane * np + seg_b[k]] == truth);
      if (ballot) {
        // the most recently started run that holds the truth: follow it
        // to its end
        const int c = __ffs(ballot) - 1;
        const int k_last = min(k + span - 1 - c, nseg - 1);
        if (lane <= k_last - k) sel_slot[k + lane] = c + lane;
        truth = cand_end[c + k_last - k][k_last];
        live = false;
        ++hops;
        burst = 1;
        k = k_last + 1;
        continue;
      }
      // no run holds it: the sweep encodes segments k .. k_end - 1 itself
      if (!live) {
        pred = truth >> 16;
        is = state_is(truth & 0xFFFF, steps);
        nx = load_next(tab, is);
        live = true;
      }
      const int k_end = min(k + burst, nseg);
      const int wb = seg_b[k_end], wb_words = min(wb, words);
      int w = seg_b[k];
      encoded += 8 * (wb_words - w) + (wb == np ? ntail : 0);
      if (w == 0 && words > 0) {              // the row's first word: both-sided clamp
        st[0] = truth;
        os[0] = encode_word<true>(pred, is, nx, src[0], tab);
        ++w;
      }
      if (w < wb_words) encode_run(src, w, wb_words, st, os, pred, is, nx, tab);
      if (wb == np) {                         // the row's tail
        st[words] = packed_state(pred, is);
        os[words] = words == 0
            ? encode_tail<true>(words, ntail, pred, is, nx, xs, tab)
            : encode_tail<false>(words, ntail, pred, is, nx, xs, tab);
      }
      truth = packed_state(pred, is);
      for (int j = k + lane; j < k_end; j += 32) sel_slot[j] = kNone;
      k = k_end;
      burst *= 2;
    }
    if (lane == 0) {
      p.pred_out[row] = truth >> 16;
      p.idx_out[row] = truth & 0xFFFF;
      if (p.diag != nullptr) {
        p.diag[kDiag * row] = hops;
        p.diag[kDiag * row + 1] = encoded;
      }
    }
  }
  __syncthreads();
  const long long t_sweep = clock64();

  // 5. the chosen candidates' words into the output; stride states (the
  // state before word 25 j) and bytes out, coalesced
  for (int k = tid; k < nseg; k += kThreads) {
    const int c = sel_slot[k];
    if (c == kNone) continue;
    const int wa = seg_b[k], wb = seg_b[k + 1];
    for (int w = wa; w < wb; ++w) os[w] = cby[c * np + w];
    for (int w = (wa + kStrideWords - 1) / kStrideWords * kStrideWords; w < wb;
         w += kStrideWords)
      st[w] = cst[c * np + w];
  }
  __syncthreads();
  const int strides = nbytes / 100;
  for (int j = tid; j < strides; j += kThreads)
    p.stride_out[(size_t)row * strides + j] = st[kStrideWords * (j + 1)];
  unsigned char* og = p.out + (size_t)row * nbytes;
  if (nbytes % 4 == 0 && reinterpret_cast<uintptr_t>(og) % 4 == 0) {
    unsigned* o32 = reinterpret_cast<unsigned*>(og);
    for (int i = tid; i < nbytes / 4; i += kThreads) o32[i] = os[i];
  } else {
    const unsigned char* ob = reinterpret_cast<const unsigned char*>(os);
    for (int i = tid; i < nbytes; i += kThreads) og[i] = ob[i];
  }
  if (tid == 0 && p.diag != nullptr) {
    const long long t_end = clock64();
    int* d = p.diag + kDiag * row;
    d[2] = longest_run;
    d[3] = (int)(t_end - t_start);
    d[4] = (int)(t_setup - t_start);
    d[5] = (int)(t_pass1 - t_setup);
    d[6] = (int)(t_sweep - t_pass1);
    d[7] = (int)(t_end - t_sweep);
  }
}

}  // namespace

// samples: (rows, ns) int16, ns even; pred0, idx0: (rows,) int32 start
// states (index 0..88); out: (rows, ns / 2) uint8; stride_out: (rows,
// ns / 200) int32, the packed state after every 100th byte; pred_out,
// idx_out: (rows,) int32.  All contiguous.  forced: 0; or, as a test input
// that changes the work and not the output, 1 to start every guessed
// segment from (-32768, 88), 2 to take no guessed run; diag: null, or
// (rows, 8) int32 (see the head of this file).
extern "C" int adpcm_seq_launch(const void* samples, const void* pred0,
                                const void* idx0, void* out, void* stride_out,
                                void* pred_out, void* idx_out, int rows,
                                int ns, int forced, void* diag, void* stream) {
  if (rows <= 0 || ns <= 0 || ns % 2 != 0 || forced < 0 || forced > 2)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, adpcm_seq_kernel);
  if (e != cudaSuccess) return (int)e;
  const size_t budget = kMaxSmemBytes - attr.sharedSizeBytes;
  const int ld = (ns + 7) & ~7;
  const int np = ns / 8 + 1;
  const int nseg = std::max(1, std::min(kSegments, ns / 8));
  // the row, output bytes and states, then the runs' slots: as long runs as
  // fit
  const size_t base = (size_t)ld * 2 + (size_t)np * 8;
  int span = std::min(kSpan, nseg);
  while (span > 1 && base + (size_t)span * np * 8 > budget) --span;
  const size_t smem = base + (size_t)span * np * 8;
  if (smem > budget) return (int)cudaErrorInvalidValue;
  if (smem + attr.sharedSizeBytes > 48 * 1024) {
    e = cudaFuncSetAttribute(adpcm_seq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Params p{static_cast<const short*>(samples), static_cast<const int*>(pred0),
           static_cast<const int*>(idx0), static_cast<unsigned char*>(out),
           static_cast<int*>(stride_out), static_cast<int*>(pred_out),
           static_cast<int*>(idx_out), static_cast<int*>(diag), rows, ns, ld, span,
           forced};
  adpcm_seq_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* owrx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
