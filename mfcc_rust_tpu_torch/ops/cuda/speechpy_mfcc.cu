// Fused speechpy MFCC for Hopper (sm_90a), plain FP32: one FFT per frame.
//
// Replaces the TPU kernel mfcc_rust_tpu/ops/pallas/speechpy_mfcc.py:155
// (mfcc_pallas / _kernel).  Frame f of row b is the fl samples at f*hop,
// zero-padded to n = fft_points (rect window); for each frame
//
//   X   = rFFT_n(frame)              a complex FFT of nc = n/2 points of
//                                    z[t] = x[2t] + i x[2t+1], then the split
//   mel = sum_k fb[m, k]/n |X_k|^2   over each filter's nonzero bins k < kmax
//   en  = (n sum_{t<fl} x_t^2 + X_0^2 + X_{n/2}^2) / 2n          (Parseval)
//   out = log(zh(mel)) @ dct,  out[0] = log(zh(en)) with dc_elim
//
// and only the (B, F, C) answer is written.
//
// The TPU kernel evaluates the DFT as a dense GEMM against a [C|S|w|±w]
// wall to fill its MXU, ~190 kFLOP a frame at the default config (fl 320,
// n 512, 40 mels), and projects onto the filterbank densely.  The FFT form
// needs ~11 kFLOP: the split and power of the kmax = 129 bins the filters
// weigh, and a sparse projection (a bin feeds at most two speechpy filters).
//
// What bounds it.  At the B=48 x 177,664 headline this design counts ~0.6
// GFLOP (~0.009 ms at the FP32 peak) against 36.9 MB that must move (each
// sample read once, each cepstrum written once: 0.011 ms at 3.35 TB/s), so
// the bound is the bytes, with the operations close behind.  What the kernel
// waits on in practice is the shared-memory traffic between FFT passes and
// the latency of its loads, so:
//
// * Samples are read once from device memory.  A block stages the samples of
//   a tile of kTileF consecutive frames of one row, (kTileF-1)*hop + fl of
//   them, into shared memory with cp.async: 16-byte copies where the global
//   and shared addresses agree modulo 16 (the slab is shifted by the tile's
//   misalignment, so any T and hop work), 4-byte copies at the ragged head
//   and tail, zeros past the row's end.  The slab is double-buffered over a
//   persistent grid (as many blocks as are resident at once), so the next
//   tile's copy overlaps this tile's work.  No frame matrix is built.
// * Path 1, nc a power of two from 64 to 512 (n 128 ... 1024; the headline
//   n 512): a register-resident FFT with no block barrier.  TPF = min(32,
//   nc/8) lanes of one warp own a frame and each holds P = nc/TPF (8 or 16)
//   complex points in registers.  The passes are radix 8, 8 and nc/64 in
//   Stockham order with the butterflies in registers; between two passes
//   the points go through the frame's own bank-padded shared buffers under
//   __syncwarp.  Twiddles come from one n-entry table through the read-only
//   cache.  The passes, the tile loop and the launch planning live in
//   fft_regs.cuh, which ct_mel.cu shares.
// * Path 2, every other even n (400, 2048, ...): the shared-memory Stockham
//   stages of fft_stages.cuh, which ct_mel.cu shares, one warp a frame and
//   __syncwarp between stages.
// * Only the kmax bins any filter weighs are split and squared.  X_0 and
//   X_{n/2} (the DC bin, the energy) are float64 sums of the frame (see
//   frame_tail).  Each filter sums its nonzero range of the packed weights
//   fb/n, which sit in shared memory with the ranges.
// * Log, the DCT-II ortho (read through the read-only cache) and
//   dc-elimination run on the warp's own frames, so nothing but the tile's
//   slab needs a block barrier.
//
// The C interface is loaded with ctypes (ops/cuda/speechpy_mfcc.py): it
// launches on the caller's stream, allocates nothing and returns the CUDA
// error code of the launch.

#include <cuda_runtime.h>
#include "fft_regs.cuh"

namespace {

using namespace fft;

constexpr int kTileF = 32;     // frames of a tile

// Path 1 when nc = n/2 is a power of two from 64 to 512, else path 2.
__host__ __device__ inline int fft_path(int n) {
  const int nc = n / 2;
  return (n % 2 == 0 && nc >= 64 && nc <= 512 && (nc & (nc - 1)) == 0) ? 1 : 2;
}

// Shared memory in floats: two slabs of a tile's samples (each with 3 floats
// of room for the alignment shift), the packed weights, the ranges (ints),
// then each warp's scratch.  Path 1, per frame of the warp: the re and im
// exchange buffers (pad8(nc) each), the power spectrum (kmax) and the log
// mels (M).  Path 2: two Stockham buffers of nc complex values (the power
// spectrum reuses the one the last stage did not write) and the log mels.
struct Layout {
  long long slab, wts, rng, warp, frame, per_warp, total;
  __host__ __device__ Layout(int n, int hop, int fl, int kmax, int nnz, int m, int warps) {
    const int nc = n / 2;
    slab = round4((long long)(kTileF - 1) * hop + fl + 3);
    wts = 2 * slab;
    rng = wts + round4(nnz);
    warp = rng + round4(3LL * m);
    if (fft_path(n) == 1) {
      frame = 2 * round4(pad8(nc)) + round4(kmax) + round4(m);
      per_warp = (32 / lanes_per_frame(nc)) * frame;
    } else {
      frame = 0;
      per_warp = 2 * round4(n) + round4(m);
    }
    total = warp + (long long)warps * per_warp;
  }
};

struct Args {
  const float* sig;
  const float2* tw;      // (n,) (cos, sin)(2 pi j / n)
  const float* wpack;    // (nnz,) each filter's weights fb/n over [lo, hi)
  const int* ranges;     // (M, 3) lo, hi, offset into wpack
  const float* dct;      // (M, C)
  float* out;            // (B, F, C)
  long long T, n_tiles;
  int F, tiles_per_row, hop, fl, n, m_odd, n4, has2, kmax, nnz, M, C, dc_elim;
  float eps;
};

// ------------------------------------------------------- frame epilogue ----
// Split and power of the kmax bins, sparse mel, log, DCT and energy of one
// frame whose FFT Z sits in shared memory (z(i) reads Z[i]); tpf lanes of
// one warp, lane lt.  X_0 = sum x_t and X_{n/2} = sum (-1)^t x_t come from
// the caller, summed in float64: the DC bin is real and cancels (on random
// frames |X_0|^2 falls to 1e-11 of its mean), and a speechpy bank's first
// filter weighs that bin alone, so its log would carry the FFT's rounding.
// out is the frame's row of C, or null for a frame past F.  Ends with the
// warp in step, the frame's buffers free again.
template <class ZAt>
__device__ __forceinline__ void frame_tail(ZAt z, float* pw, float* lm, float s2, float x0,
                                           float xn, const Args& A, const float* wts,
                                           const int* rng, float* out, int lt, int tpf) {
  const int nc = A.n / 2;
  for (int k = lt; k < A.kmax; k += tpf) {
    if (k == 0 || k == nc) {
      pw[k] = k ? xn * xn : x0 * x0;
    } else {
      const float2 x = fft::real_split(z, k, nc, A.tw);
      pw[k] = fmaf(x.x, x.x, x.y * x.y);
    }
  }
  __syncwarp();
  for (int m = lt; m < A.M; m += tpf) {
    const int lo = rng[3 * m], hi = rng[3 * m + 1];
    const float* w = wts + rng[3 * m + 2] - lo;
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) acc = fmaf(w[k], pw[k], acc);
    lm[m] = logf(acc == 0.f ? A.eps : acc);  // zero handling (f32 epsilon)
  }
  __syncwarp();
  if (out) {
    for (int c = lt; c < A.C; c += tpf) {
      float v;
      if (A.dc_elim && c == 0) {
        const float en = ((float)A.n * s2 + (x0 * x0 + xn * xn)) * (1.f / (2.f * (float)A.n));
        v = logf(en == 0.f ? A.eps : en);
      } else {
        v = 0.f;
        for (int m = 0; m < A.M; ++m) v = fmaf(lm[m], __ldg(A.dct + m * A.C + c), v);
      }
      out[c] = v;
    }
  }
  __syncwarp();
}

// --------------------------------------------- path 1: FFT in registers ----
// The frames of a tile on path 1: warp w's frame groups take frames
// w*FPW + g, then every nw*FPW further (the same count for every lane).
template <int NC>
__device__ __forceinline__ void tile_path1(const Args& A, const float* slab, float* scratch,
                                           long long frame_floats, const float* wts,
                                           const int* rng, int f0, float* out_row, int warp,
                                           int lane, int nw) {
  using Q = P1<NC>;
  const int g = lane / Q::TPF;
  const int lt = lane - g * Q::TPF;
  float* re = scratch + g * frame_floats;
  float* im = re + Q::BUF;
  float* pw = im + Q::BUF;
  float* lm = pw + round4(A.kmax);
  for (int s = warp * Q::FPW + g; s < kTileF; s += nw * Q::FPW) {
    const float* x = slab + s * A.hop;
    float2 a[Q::P];
    float s2 = 0.f;
    double d0 = 0.0, dn = 0.0;
#pragma unroll
    for (int q = 0; q < Q::P; ++q) {
      const int i = 2 * (lt + Q::TPF * q);  // samples past fl are the zero pad
      const float x0 = i < A.fl ? x[i] : 0.f;
      const float x1 = i + 1 < A.fl ? x[i + 1] : 0.f;
      s2 = fmaf(x0, x0, fmaf(x1, x1, s2));
      d0 += (double)x0 + (double)x1;
      dn += (double)x0 - (double)x1;
      a[q] = make_float2(x0, x1);
    }
    fft_regs<NC>(a, re, im, A.tw, lt);
#pragma unroll
    for (int o = Q::TPF / 2; o > 0; o >>= 1) {
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      dn += __shfl_xor_sync(0xffffffffu, dn, o);
    }
    const int f = f0 + s;
    frame_tail([re, im](int i) { return make_float2(re[pad8(i)], im[pad8(i)]); }, pw, lm, s2,
               (float)d0, (float)dn, A, wts, rng,
               f < A.F ? out_row + (long long)f * A.C : nullptr, lt, Q::TPF);
  }
}

// ------------------------------------ path 2: Stockham in shared memory ----
__device__ __forceinline__ void tile_path2(const Args& A, const float* slab, float* scratch,
                                           const float* wts, const int* rng, int f0,
                                           float* out_row, int warp, int lane, int nw) {
  const int nc = A.n / 2;
  float2* buf0 = reinterpret_cast<float2*>(scratch);
  float2* buf1 = reinterpret_cast<float2*>(scratch + round4(A.n));
  float* lm = scratch + 2 * round4(A.n);
  for (int s = warp; s < kTileF; s += nw) {
    const float* x = slab + s * A.hop;
    float s2 = 0.f;
    double d0 = 0.0, dn = 0.0;
    for (int t = lane; t < nc; t += 32) {
      const int i = 2 * t;
      const float x0 = i < A.fl ? x[i] : 0.f;
      const float x1 = i + 1 < A.fl ? x[i + 1] : 0.f;
      s2 = fmaf(x0, x0, fmaf(x1, x1, s2));
      d0 += (double)x0 + (double)x1;
      dn += (double)x0 - (double)x1;
      buf0[t] = make_float2(x0, x1);
    }
    for (int o = 16; o > 0; o >>= 1) {
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      dn += __shfl_xor_sync(0xffffffffu, dn, o);
    }
    __syncwarp();
    const int src = fft::stockham(buf0, buf1, A.tw, nc, A.n, A.m_odd, A.n4, A.has2, lane, 32,
                                  fft::WarpSync{});
    const float2* z = src ? buf1 : buf0;
    float* pw = reinterpret_cast<float*>(src ? buf0 : buf1);
    const int f = f0 + s;
    frame_tail([z](int i) { return z[i]; }, pw, lm, s2, (float)d0, (float)dn, A, wts, rng,
               f < A.F ? out_row + (long long)f * A.C : nullptr, lane, 32);
  }
}

// ------------------------------------------------------------- kernel ----
// NC > 0: path 1 for that nc; NC == 0: path 2.  The persistent tile loop of
// fft_regs.cuh over tiles of kTileF frames.
template <int NC>
__global__ void __launch_bounds__(kMaxWarps * 32, 2) mfcc_fft_kernel(const Args A) {
  extern __shared__ __align__(16) float smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Layout lay(A.n, A.hop, A.fl, A.kmax, A.nnz, A.M, nw);
  float* wts = smem + lay.wts;
  int* rng = reinterpret_cast<int*>(smem + lay.rng);
  float* scratch = smem + lay.warp + warp * lay.per_warp;
  for (int i = threadIdx.x; i < A.nnz; i += blockDim.x) wts[i] = __ldg(A.wpack + i);
  for (int i = threadIdx.x; i < 3 * A.M; i += blockDim.x) rng[i] = __ldg(A.ranges + i);
  tile_loop(smem, lay.slab, A.sig, A.T, A.n_tiles, A.tiles_per_row, kTileF, A.hop,
            (kTileF - 1) * A.hop + A.fl, [&](const float* slab, long long b, int f0) {
              float* out_row = A.out + b * A.F * A.C;
              if constexpr (NC > 0)
                tile_path1<NC>(A, slab, scratch, lay.frame, wts, rng, f0, out_row, warp, lane,
                               nw);
              else
                tile_path2(A, slab, scratch, wts, rng, f0, out_row, warp, lane, nw);
            });
}

template <int NC>
cudaError_t launch_as(const Args& A, const Plan& p, cudaStream_t stream) {
  mfcc_fft_kernel<NC><<<(unsigned)p.grid, p.warps * 32, (size_t)p.smem, stream>>>(A);
  return cudaGetLastError();
}

// Launch shape: warps, the most (of 8, 4, 2, 1) for which two blocks share
// an SM, else the most for which one block fits; a persistent grid of every
// resident block (persistent_grid in fft_regs.cuh, its occupancy query run
// once per shape).
cudaError_t make_plan(Plan& p, int n, int hop, int fl, int kmax, int nnz, int m,
                      long long n_tiles) {
  p.path = fft_path(n);
  auto bytes = [&](int w) { return Layout(n, hop, fl, kmax, nnz, m, w).total * 4; };
  p.warps = most_warps(bytes, kMaxSmem / 2);
  if (!p.warps) p.warps = most_warps(bytes, kMaxSmem);
  if (!p.warps || n_tiles <= 0) return cudaErrorInvalidValue;
  p.smem = bytes(p.warps);
  if (p.path == 2) return persistent_grid(p, mfcc_fft_kernel<0>, n_tiles);
  switch (n / 2) {
    case 64: return persistent_grid(p, mfcc_fft_kernel<64>, n_tiles);
    case 128: return persistent_grid(p, mfcc_fft_kernel<128>, n_tiles);
    case 256: return persistent_grid(p, mfcc_fft_kernel<256>, n_tiles);
    default: return persistent_grid(p, mfcc_fft_kernel<512>, n_tiles);
  }
}

}  // namespace

extern "C" int mfcc_fft_path(int n) { return fft_path(n); }

extern "C" long long mfcc_fft_smem_bytes(int n, int hop, int fl, int kmax, int nnz, int m,
                                         int warps) {
  return Layout(n, hop, fl, kmax, nnz, m, warps).total * (long long)sizeof(float);
}

// The launch shape for n_tiles tiles on the current device: info = (path,
// warps, shared bytes, blocks per SM, grid).  Returns a cudaError_t.
extern "C" int mfcc_fft_plan(int n, int hop, int fl, int kmax, int nnz, int m,
                             long long n_tiles, long long* info) {
  Plan p;
  const cudaError_t e = make_plan(p, n, hop, fl, kmax, nnz, m, n_tiles);
  if (e != cudaSuccess) return (int)e;
  info[0] = p.path;
  info[1] = p.warps;
  info[2] = p.smem;
  info[3] = p.blocks_per_sm;
  info[4] = p.grid;
  return 0;
}

// sig (B, T), tw (n, 2) = (cos, sin)(2 pi j / n), wpack (nnz,), ranges (M, 3)
// int32 (lo, hi, offset into wpack) with hi <= kmax <= n/2 + 1, dct (M, C),
// out (B, F, C): contiguous on the current device, F = (T - fl) // hop > 0.
// n/2 = m_odd * 4^n4 * 2^has2 with m_odd odd (path 2's stages).  Returns a
// cudaError_t.
extern "C" int mfcc_fft_launch(const float* sig, const float* tw, const float* wpack,
                               const int* ranges, const float* dct, float* out, int B,
                               long long T, int F, int hop, int fl, int n, int m_odd, int n4,
                               int has2, int kmax, int nnz, int M, int C, int dc_elim,
                               float eps, void* stream) {
  long long prod = m_odd;
  for (int s = 0; s < n4; ++s) prod *= 4;
  if (has2) prod *= 2;
  if (B <= 0 || F <= 0 || hop <= 0 || fl <= 0 || fl > n || n % 2 || m_odd % 2 == 0 ||
      prod != n / 2 || kmax > n / 2 + 1 || nnz < 0 || M <= 0 || C <= 0 ||
      (long long)(F - 1) * hop + fl > T)
    return (int)cudaErrorInvalidValue;
  Args A;
  A.sig = sig;
  A.tw = reinterpret_cast<const float2*>(tw);
  A.wpack = wpack;
  A.ranges = ranges;
  A.dct = dct;
  A.out = out;
  A.T = T;
  A.F = F;
  A.tiles_per_row = (F + kTileF - 1) / kTileF;
  A.n_tiles = (long long)B * A.tiles_per_row;
  A.hop = hop;
  A.fl = fl;
  A.n = n;
  A.m_odd = m_odd;
  A.n4 = n4;
  A.has2 = has2;
  A.kmax = kmax;
  A.nnz = nnz;
  A.M = M;
  A.C = C;
  A.dc_elim = dc_elim;
  A.eps = eps;
  Plan p;
  cudaError_t e = make_plan(p, n, hop, fl, kmax, nnz, M, A.n_tiles);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.path == 2) return (int)launch_as<0>(A, p, s);
  switch (n / 2) {
    case 64: return (int)launch_as<64>(A, p, s);
    case 128: return (int)launch_as<128>(A, p, s);
    case 256: return (int)launch_as<256>(A, p, s);
    default: return (int)launch_as<512>(A, p, s);
  }
}

extern "C" const char* mfcc_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
