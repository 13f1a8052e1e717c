// Block-parallel Viterbi decoder for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA foreign function interface (decoder/core_cuda.py).
//
// One warp decodes one overlap-save block of the plan (core_xla.BlockPlan):
// dec_len + 64 add-compare-select stages from path metrics reset to zero,
// then a traceback from state 0 at the block's end.  The decoded bits are
// identical to decode_packed_xla's (same branch metrics, same tie-break,
// same register-exchange survivor packs, same traceback start).
//
// Layout (after the reference's shuffle-exchange butterfly, SURVEY.md §3.3):
// each lane holds two of the 64 states, the pair {i, i+32} whose children
// are {2i, 2i+1}, so the butterfly itself is lane-local.  After it one
// __shfl_xor_sync per quantity (path metric, path word) swaps half of the
// children with the partner lane, which rotates the state<->lane map by one
// bit.  With 5 lane bits the map returns to its start every 5 stages:
//   at phase p, lane l, register r holds state rotl5(l, p) | (r << 5),
// and the exchange partner differs in lane bit (4 - p) mod 5.
//
// Input: the flat packed channel-word stream (MSB = earliest field).  Block
// b reads words [b * wpb, b * wpb + wpb + halo) straight from it; words past
// the stream's end read as 0 (the natural framing's zero-padded tail).  Each
// lane loads one word of a 32-word chunk, one chunk ahead, and the stage
// loop broadcasts the current word with __shfl_sync.  FP32 input arrives as
// SOFT8-format (u, d) = (trunc(r0 + r1), trunc(r0 - r1)) words
// (core_xla.fp32_ud_words), mode 4.
//
// Survivors: at the end of each pack of BPP stages every state's 32-bit
// register-exchange path word goes to global scratch, [block][pack][state].
// Lane 0 then chases the packs from state 0 at the last pack, as
// core_xla.traceback_scan does, and writes the block's dec_len / BPP output
// packs to out[block * n_emit ...].

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerCta = 2;

// channel modes: ChannelIn's values for the integer formats, 4 = FP32 (u, d)
enum Mode : int { kHard = 0, kSoft4 = 1, kSoft8 = 2, kSoft16 = 3, kUd = 4 };

template <int MODE>
struct Field {
  static constexpr int kWidth = MODE == kHard ? 1 : MODE == kSoft4 ? 4
                                : MODE == kSoft16 ? 16 : 8;
  static constexpr int kPerWord = 32 / kWidth;      // fields per word
  static constexpr int kStagesPerWord = kPerWord / 2;

  // field f (0 = most significant) of w as a signed value; HARD maps the
  // bit to -1 / +1
  static __device__ __forceinline__ int get(uint32_t w, int f) {
    if (MODE == kHard) return static_cast<int>((w >> (31 - f)) & 1u) * 2 - 1;
    return static_cast<int>(w << (kWidth * f)) >> (32 - kWidth);
  }
};

__device__ __forceinline__ int rotl5(int x, int p) {
  p %= 5;
  return ((x << p) | (x >> (5 - p))) & 31;
}

struct Carry {
  int pm0, pm1;          // path metrics of the lane's two states
  uint32_t pp0, pp1;     // their register-exchange path words
  uint32_t wcur, wnext;  // this lane's word of the current / next chunk
};

struct BlockArgs {
  const int32_t* words;
  long long n_words;
  long long base;        // first word of this block
  uint32_t* surv;        // this block's survivor packs
  int lane;
  bool renorm;
};

template <int MODE>
__device__ __forceinline__ uint32_t load_chunk(const BlockArgs& a, int c) {
  const long long idx = a.base + 32LL * c + a.lane;
  return idx < a.n_words ? static_cast<uint32_t>(__ldg(a.words + idx)) : 0u;
}

// BPP stages starting at phase PH0, then the pack's survivor dump.
template <int MODE, int BPP, int PH0>
__device__ __forceinline__ void run_pack(Carry& c, int k, const BlockArgs& a,
                                         const int (&ca)[5],
                                         const int (&cb)[5]) {
  using F = Field<MODE>;
  constexpr int kWordsPerPack = BPP / F::kStagesPerWord;
  constexpr int kPacksPerChunk = 32 / kWordsPerPack;
  if (k % kPacksPerChunk == 0) {
    c.wcur = c.wnext;
    c.wnext = load_chunk<MODE>(a, k / kPacksPerChunk + 1);
  }
  const int word0 = k * kWordsPerPack;
  uint32_t w = 0;
#pragma unroll
  for (int s = 0; s < BPP; ++s) {
    const int ph = (PH0 + s) % 5;
    if (s % F::kStagesPerWord == 0)
      w = __shfl_sync(kFull, c.wcur, (word0 + s / F::kStagesPerWord) & 31);
    const int f = (2 * s) % F::kPerWord;
    const int x = F::get(w, f);
    const int y = F::get(w, f + 1);
    // branch metric of the even child on its j = 0 branch; the odd child's
    // is its negation, and each j = 1 branch negates again
    const int bm = ca[ph] * x + cb[ph] * y;
    const int e0 = c.pm0 + bm, e1 = c.pm1 - bm;
    const int o0 = c.pm0 - bm, o1 = c.pm1 + bm;
    const bool de = e1 > e0, dodd = o1 > o0;  // ties keep j = 0
    const int ne = de ? e1 : e0, no = dodd ? o1 : o0;
    const uint32_t qe = ((de ? c.pp1 : c.pp0) << 1) | static_cast<uint32_t>(de);
    const uint32_t qo =
        ((dodd ? c.pp1 : c.pp0) << 1) | static_cast<uint32_t>(dodd);
    const int m = (9 - ph) % 5;  // lane bit that holds the children's bit 5
    const bool hi = (a.lane >> m) & 1;
    const int rpm = __shfl_xor_sync(kFull, hi ? ne : no, 1 << m);
    const uint32_t rpp = __shfl_xor_sync(kFull, hi ? qe : qo, 1 << m);
    c.pm0 = hi ? rpm : ne;
    c.pm1 = hi ? no : rpm;
    c.pp0 = hi ? rpp : qe;
    c.pp1 = hi ? qo : rpp;
  }
  const int st = rotl5(a.lane, (PH0 + BPP) % 5);
  uint32_t* dst = a.surv + static_cast<long long>(k) * 64;
  dst[st] = c.pp0;
  dst[st + 32] = c.pp1;
  if (a.renorm) {  // decision-invariant min-subtract (core_xla._renorm)
    int mn = min(c.pm0, c.pm1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mn = min(mn, __shfl_xor_sync(kFull, mn, off));
    c.pm0 -= mn;
    c.pm1 -= mn;
  }
}

template <int MODE, int BPP>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
    viterbi_kernel(const int32_t* __restrict__ words, long long n_words,
                   int dec_len, int num_blocks, int n_packs, int renorm,
                   uint32_t* __restrict__ out, uint32_t* __restrict__ surv) {
  const int lane = threadIdx.x & 31;
  const int blk = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (blk >= num_blocks) return;

  // per-phase coefficients of the even child's branch metric: its code
  // c = 2 * out0 + out1 gives signs (2 * out0 - 1, 2 * out1 - 1) on
  // (r0, r1); on (u, d) words the same metric is +-u or +-d
  int ca[5], cb[5];
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    const int s = 2 * rotl5(lane, p);
    const int s0 = 2 * (__popc(s & 0117) & 1) - 1;  // taps of 0o171, reversed
    const int s1 = 2 * (__popc(s & 0155) & 1) - 1;  // taps of 0o133, reversed
    if (MODE == kUd) {
      ca[p] = s0 == s1 ? s0 : 0;
      cb[p] = s0 == s1 ? 0 : s0;
    } else {
      ca[p] = s0;
      cb[p] = s1;
    }
  }

  BlockArgs a;
  a.words = words;
  a.n_words = n_words;
  a.base = static_cast<long long>(blk) * (2LL * dec_len / Field<MODE>::kPerWord);
  a.surv = surv + static_cast<long long>(blk) * n_packs * 64;
  a.lane = lane;
  a.renorm = renorm != 0;

  Carry c{0, 0, 0u, 0u, 0u, 0u};
  c.wnext = load_chunk<MODE>(a, 0);
  // pack k starts at phase (k * BPP) mod 5, so five packs make one period
  for (int k = 0; k < n_packs; k += 5) {
    run_pack<MODE, BPP, 0>(c, k, a, ca, cb);
    if (k + 1 >= n_packs) break;
    run_pack<MODE, BPP, (1 * BPP) % 5>(c, k + 1, a, ca, cb);
    if (k + 2 >= n_packs) break;
    run_pack<MODE, BPP, (2 * BPP) % 5>(c, k + 2, a, ca, cb);
    if (k + 3 >= n_packs) break;
    run_pack<MODE, BPP, (3 * BPP) % 5>(c, k + 3, a, ca, cb);
    if (k + 4 >= n_packs) break;
    run_pack<MODE, BPP, (4 * BPP) % 5>(c, k + 4, a, ca, cb);
  }
  __syncwarp();

  if (lane == 0) {
    const int n_emit = dec_len / BPP;
    const int n_conv = (38 - BPP + BPP - 1) / BPP;  // extra_r = 38 stages
    const int lo = n_packs - n_conv - n_emit;
    uint32_t* o = out + static_cast<long long>(blk) * n_emit;
    int state = 0;
    for (int k = n_packs - 1; k >= lo; --k) {
      const uint32_t v = a.surv[static_cast<long long>(k) * 64 + state];
      if (k < lo + n_emit) o[k - lo] = BPP == 16 ? (v & 0xFFFFu) : v;
      state = static_cast<int>((v >> (BPP - 6)) & 63u);
    }
  }
}

template <int MODE, int BPP>
cudaError_t launch(cudaStream_t stream, const int32_t* words,
                   long long n_words, int dec_len, int num_blocks,
                   int n_packs, int renorm, uint32_t* out, uint32_t* surv) {
  const int ctas = (num_blocks + kWarpsPerCta - 1) / kWarpsPerCta;
  viterbi_kernel<MODE, BPP><<<ctas, 32 * kWarpsPerCta, 0, stream>>>(
      words, n_words, dec_len, num_blocks, n_packs, renorm, out, surv);
  return cudaGetLastError();
}

template <int BPP>
cudaError_t launch_mode(int mode, cudaStream_t stream, const int32_t* words,
                        long long n_words, int dec_len, int num_blocks,
                        int n_packs, int renorm, uint32_t* out,
                        uint32_t* surv) {
  switch (mode) {
    case kHard:
      return launch<kHard, BPP>(stream, words, n_words, dec_len, num_blocks,
                                n_packs, renorm, out, surv);
    case kSoft4:
      return launch<kSoft4, BPP>(stream, words, n_words, dec_len, num_blocks,
                                 n_packs, renorm, out, surv);
    case kSoft8:
      return launch<kSoft8, BPP>(stream, words, n_words, dec_len, num_blocks,
                                 n_packs, renorm, out, surv);
    case kSoft16:
      return launch<kSoft16, BPP>(stream, words, n_words, dec_len,
                                  num_blocks, n_packs, renorm, out, surv);
    default:
      return launch<kUd, BPP>(stream, words, n_words, dec_len, num_blocks,
                              n_packs, renorm, out, surv);
  }
}

ffi::Error decode_impl(cudaStream_t stream, ffi::Buffer<ffi::S32> words,
                       ffi::ResultBuffer<ffi::U32> out,
                       ffi::ResultBuffer<ffi::U32> surv, int64_t mode,
                       int64_t bpp, int64_t dec_len, int64_t num_blocks,
                       int64_t renorm) {
  if (mode < kHard || mode > kUd || (bpp != 16 && bpp != 32) ||
      dec_len <= 0 || dec_len % bpp || num_blocks <= 0)
    return ffi::Error::InvalidArgument("viterbi_decode: bad attributes");
  const int n_packs = static_cast<int>((dec_len + 64) / bpp);
  if (out->element_count() !=
          static_cast<size_t>(num_blocks * (dec_len / bpp)) ||
      surv->element_count() != static_cast<size_t>(num_blocks) * n_packs * 64)
    return ffi::Error::InvalidArgument("viterbi_decode: bad result shapes");
  const long long n_words = static_cast<long long>(words.element_count());
  const cudaError_t err =
      bpp == 32
          ? launch_mode<32>(static_cast<int>(mode), stream, words.typed_data(),
                            n_words, static_cast<int>(dec_len),
                            static_cast<int>(num_blocks), n_packs,
                            static_cast<int>(renorm), out->typed_data(),
                            surv->typed_data())
          : launch_mode<16>(static_cast<int>(mode), stream, words.typed_data(),
                            n_words, static_cast<int>(dec_len),
                            static_cast<int>(num_blocks), n_packs,
                            static_cast<int>(renorm), out->typed_data(),
                            surv->typed_data());
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("viterbi_decode: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(ViterbiDecode, decode_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int64_t>("mode")
                                  .Attr<int64_t>("bpp")
                                  .Attr<int64_t>("dec_len")
                                  .Attr<int64_t>("num_blocks")
                                  .Attr<int64_t>("renorm"));
