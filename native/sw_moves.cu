// Banded affine Smith-Waterman with packed 2-bit move planes, for NVIDIA
// Hopper (sm_90a), called from JAX through the XLA FFI.
//
// Semantics are those of biokanga/ops/sw_moves.py:sw_moves_ref (and of
// ops/sw.py:banded_sw_batch, whose lazy-F row recurrence it shares):
// per pair p, rows i = 0..alen-1 of the query, band cells k = 0..K-1
// (K = 2W+1) in normalised coordinates j = i + k - W, target base
// bwin[p, i + k].  Outputs: best score, its row and band cell (earliest
// row, then lowest cell, on ties), and the move code of every cell packed
// 16 rows per int32: mv[p, i / 16, k] holds code(i, k) at bit 2 * (i % 16).
//
// Layout: one warp per pair.  Lane l owns the CPL consecutive band cells
// k = l*CPL .. l*CPL+CPL-1 in registers, so a one-cell band shift is a
// register move plus one shuffle, and the lazy-F prefix max along the band
// is a serial scan over the lane's cells followed by a 5-step warp scan of
// the lane totals.  The target window slides one cell per row, so each row
// loads a single new target base.
//
// Build: biokanga/ops/sw_moves.py compiles this file with nvcc at first
// use (see build_cuda_library there).

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SW_DEV __device__ __forceinline__
#define SW_GLOBAL __global__
#else
// Host-only syntax check (g++ -fsyntax-only -DSW_MOVES_SYNTAX_ONLY): the
// CUDA built-ins below are stand-ins and never run.
struct cudaStream_st;
typedef cudaStream_st* cudaStream_t;
typedef int cudaError_t;
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx, blockIdx, blockDim;
#define SW_DEV inline
#define SW_GLOBAL
template <typename T> T __shfl_sync(unsigned, T v, int) { return v; }
template <typename T> T __shfl_up_sync(unsigned, T v, unsigned) { return v; }
template <typename T> T __shfl_down_sync(unsigned, T v, unsigned) { return v; }
template <typename T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
static inline cudaError_t cudaGetLastError() { return 0; }
static inline const char* cudaGetErrorString(cudaError_t) { return ""; }
#endif

namespace ffi = xla::ffi;

namespace {

constexpr int kNeg = -10000000;  // ops/sw.py NEG
constexpr int kStop = 0, kDiag = 1, kUp = 2, kLeft = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

SW_DEV int imax(int a, int b) { return a > b ? a : b; }

template <int CPL>
SW_GLOBAL void sw_moves_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bw,
    const int32_t* __restrict__ alen, const int32_t* __restrict__ jlo,
    const int32_t* __restrict__ jhi, int B, int La, int T, int W, int match,
    int mismatch, int gap_open, int gap_ext, int32_t* __restrict__ best_out,
    int32_t* __restrict__ bi_out, int32_t* __restrict__ bk_out,
    int32_t* __restrict__ mv) {
  constexpr int KP = 32 * CPL;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= B) return;  // warp-uniform
  const int K = 2 * W + 1;
  const int k0 = lane * CPL;
  const int8_t* ap = a + (size_t)p * La;
  const int8_t* bp = bw + (size_t)p * T;
  const int Wd = La / 16;
  int32_t* mvp = mv + (size_t)p * Wd * KP;
  const int al = alen[p] < La ? (alen[p] > 0 ? alen[p] : 0) : La;
  const int lo = jlo[p], hi = jhi[p];

  int H[CPL], E[CPL], bj[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    H[c] = 0;
    E[c] = kNeg;
    bj[c] = bp[k0 + c];
  }
  int lbest = 0, lbi = 0, lbk = 0;
  const int nw = (al + 15) / 16;

  for (int w = 0; w < nw; ++w) {
    int word[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) word[c] = 0;
    const int rmax = al - w * 16 < 16 ? al - w * 16 : 16;
    for (int r = 0; r < rmax; ++r) {
      const int i = w * 16 + r;
      const int ai = ap[i];
      // band shifts: cell k reads k+1 of the previous row (top cell NEG)
      int hn = __shfl_down_sync(kFull, H[0], 1);
      int en = __shfl_down_sync(kFull, E[0], 1);
      if (lane == 31) {
        hn = kNeg;
        en = kNeg;
      }
      int Hd[CPL], H0[CPL], En[CPL], run[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int hu = c + 1 < CPL ? H[c + 1] : hn;
        const int eu = c + 1 < CPL ? E[c + 1] : en;
        En[c] = imax(hu + gap_open, eu + gap_ext);
        const int b = bj[c];
        const int sub = (ai == b && ai < 4 && b < 4) ? match : mismatch;
        Hd[c] = H[c] + sub;
        int h0 = imax(imax(Hd[c], En[c]), 0);
        H0[c] = imax(h0, sub > 0 ? sub : 0);
        const int v = H0[c] - gap_ext * (k0 + c);
        run[c] = c == 0 ? v : imax(run[c - 1], v);
      }
      // inclusive warp scan of lane totals, then shift to exclusive
      int incl = run[CPL - 1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl = imax(incl, v);
      }
      int excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = kNeg;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int k = k0 + c;
        const int rp = c == 0 ? excl : imax(excl, run[c - 1]);
        const int F = rp + gap_ext * k + gap_open - gap_ext;
        const int h = imax(imax(H0[c], F), 0);
        const int j = i + k - W;
        const bool inb = (j >= lo) && (j < hi) && (k < K);
        const int hv = inb ? h : kNeg;
        const int ev = inb ? En[c] : kNeg;
        int code = kStop;
        if (hv > 0) {
          if (hv == F) code = kLeft;
          if (hv == ev) code = kUp;
          if (hv == Hd[c]) code = kDiag;
        }
        word[c] |= code << (2 * r);
        if (hv > lbest) {
          lbest = hv;
          lbi = i;
          lbk = k;
        }
        H[c] = hv;
        E[c] = ev;
      }
      // slide the target window one cell: bwin[i + 1 + k]
      int bn = __shfl_down_sync(kFull, bj[0], 1);
      if (lane == 31) bn = bp[i + KP];
#pragma unroll
      for (int c = 0; c < CPL - 1; ++c) bj[c] = bj[c + 1];
      bj[CPL - 1] = bn;
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) mvp[(size_t)w * KP + k0 + c] = word[c];
  }
  for (int w = nw; w < Wd; ++w) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) mvp[(size_t)w * KP + k0 + c] = 0;
  }
  // (best, earliest row, lowest cell) across the warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(kFull, lbest, off);
    const int oi = __shfl_xor_sync(kFull, lbi, off);
    const int ok = __shfl_xor_sync(kFull, lbk, off);
    if (ob > lbest || (ob == lbest && (oi < lbi || (oi == lbi && ok < lbk)))) {
      lbest = ob;
      lbi = oi;
      lbk = ok;
    }
  }
  if (lane == 0) {
    best_out[p] = lbest;
    bi_out[p] = lbi;
    bk_out[p] = lbk;
  }
}

template <int CPL>
void launch(cudaStream_t stream, const int8_t* a, const int8_t* bw,
            const int32_t* alen, const int32_t* jlo, const int32_t* jhi,
            int B, int La, int T, int W, int match, int mismatch,
            int gap_open, int gap_ext, int32_t* best, int32_t* bi,
            int32_t* bk, int32_t* mv) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
#ifdef __CUDACC__
  sw_moves_kernel<CPL><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      a, bw, alen, jlo, jhi, B, La, T, W, match, mismatch, gap_open,
      gap_ext, best, bi, bk, mv);
#else
  (void)blocks;
  sw_moves_kernel<CPL>(a, bw, alen, jlo, jhi, B, La, T, W, match, mismatch,
                       gap_open, gap_ext, best, bi, bk, mv);
#endif
}

ffi::Error SwMovesImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> a,
                       ffi::Buffer<ffi::S8> bw, ffi::Buffer<ffi::S32> alen,
                       ffi::Buffer<ffi::S32> jlo, ffi::Buffer<ffi::S32> jhi,
                       int64_t W, int64_t match, int64_t mismatch,
                       int64_t gap_open, int64_t gap_ext,
                       ffi::ResultBuffer<ffi::S32> best,
                       ffi::ResultBuffer<ffi::S32> bi,
                       ffi::ResultBuffer<ffi::S32> bk,
                       ffi::ResultBuffer<ffi::S32> mv) {
  const auto ad = a.dimensions();
  const auto bd = bw.dimensions();
  const auto md = mv->dimensions();
  if (ad.size() != 2 || bd.size() != 2 || md.size() != 3) {
    return ffi::Error::InvalidArgument("sw_moves: bad ranks");
  }
  const int B = static_cast<int>(ad[0]);
  const int La = static_cast<int>(ad[1]);
  const int T = static_cast<int>(bd[1]);
  const int KP = static_cast<int>(md[2]);
  const int CPL = KP / 32;
  if (La % 16 != 0 || md[1] != La / 16 || md[0] != B || bd[0] != B ||
      KP % 32 != 0 || 2 * W + 1 > KP || T < La + KP) {
    return ffi::Error::InvalidArgument(
        "sw_moves: need La % 16 == 0, mv (B, La/16, KP), 2W+1 <= KP, "
        "T >= La + KP");
  }
  if (B == 0) return ffi::Error::Success();
#define SW_CASE(n)                                                           \
  case n:                                                                    \
    launch<n>(stream, a.typed_data(), bw.typed_data(), alen.typed_data(),    \
              jlo.typed_data(), jhi.typed_data(), B, La, T,                  \
              static_cast<int>(W), static_cast<int>(match),                  \
              static_cast<int>(mismatch), static_cast<int>(gap_open),        \
              static_cast<int>(gap_ext), best->typed_data(),                 \
              bi->typed_data(), bk->typed_data(), mv->typed_data());         \
    break;
  switch (CPL) {
    SW_CASE(1)
    SW_CASE(2)
    SW_CASE(3)
    SW_CASE(4)
    SW_CASE(5)
    SW_CASE(6)
    SW_CASE(7)
    SW_CASE(8)
    default:
      return ffi::Error::InvalidArgument(
          "sw_moves: band of more than 256 cells (W > 127)");
  }
#undef SW_CASE
  const cudaError_t err = cudaGetLastError();
  if (err != 0) {
    return ffi::Error::Internal(std::string("sw_moves launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    BiokangaSwMoves, SwMovesImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Attr<int64_t>("W")
        .Attr<int64_t>("match")
        .Attr<int64_t>("mismatch")
        .Attr<int64_t>("gap_open")
        .Attr<int64_t>("gap_ext")
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>());
