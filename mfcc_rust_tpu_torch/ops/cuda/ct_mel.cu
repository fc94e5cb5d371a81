// librosa mel power spectrogram by a Cooley-Tukey FFT, for Hopper
// (sm_90a), plain FP32.
//
// Replaces the TPU kernel mfcc_rust_tpu/ops/pallas/ct_mel.py (ct_mel_pallas
// / _kernel).  For each frame f of n samples starting at f*hop of the
// (already centre-padded) signal row b:
//
//   mel[b, f, m] = sum_k fb[m, k] * |rFFT(x_f * w)[k]|^2
//
// written frame-major (B, F, M).  The real n-point FFT is a complex
// Nc = n/2-point FFT of z[t] = xw[2t] + i xw[2t+1] followed by the usual
// split (X[k] = E[k] + W_n^k O[k], E and O from Z[k] and conj Z[Nc-k]).
//
// What bounds it.  At the librosa main path (n 2048, hop 512, 128 slaney
// mels, 17,248 frames) the FFT is ~50 kFLOP a frame and the split, power and
// sparse projection ~25 kFLOP more, against 8 KB of samples (each read by
// four frames at hop 512) and 512 B written: ~1.1 GFLOP and ~44 MB a call,
// so the operation bound (~0.017 ms) sits just above the byte bound.  What
// the kernel waits on is the shared-memory and L1 data path (exchanges,
// loads, the mel's reads) and the barriers between FFT steps.  Two paths:
//
// * Path 1, nc a power of two from 64 to 1024 (n 128 ... 2048) whose tile
//   fits: the register FFT of fft_regs.cuh, one warp a frame (TPF =
//   min(32, nc/8) lanes of it at nc < 256), with no block barrier inside a
//   frame.  A persistent grid of as many blocks as are resident at once
//   walks over tiles of kTileF consecutive frames of one row; a tile's
//   (kTileF-1)*hop + n samples are staged by cp.async, double-buffered, the
//   next tile in flight (tile_loop of fft_regs.cuh, which K1 shares; so is
//   the launch planning).  The window, the packed weights and
//   the ranges go into shared memory once per block.  A lane loads its
//   points from the slab with the window applied, as float2 pairs where the
//   frame starts on an even offset of the slab and as scalars where it does
//   not (an odd hop).  At nc = 1024 the last pass keeps Z in registers and
//   the real split takes Z[nc - k] from the partner lane by shuffle, with
//   W_n^k = W_n^lt W_64^j (k = lt + 32 j) from one table read and a
//   constant; below, Z goes through the frame's padded buffers as in K1.
//   The power of the kmax bins goes to shared memory, then each lane sums
//   its filters over their packed ranges and writes (B, F, M) frame-major.
//   The only block barriers are the two per tile around the slab.
// * Path 2, every other even n (768, 1280, 4096, ...), or a tile that does
//   not fit: G frames a block, each frame's n samples read through the
//   read-only cache, the Stockham stages of fft_stages.cuh in shared memory
//   with a block barrier between stages, the split and the sparse mel.
//   The host picks G (<= 8) so that three blocks fit on an SM.
//
// Operations first: the TPU kernel factors n = 128 x 16 to fill the MXU and
// spends ~1 MFLOP a frame on twiddle-folded GEMMs whose 1.97 MB of constants
// it keeps in VMEM; both paths here run an FFT (~20x fewer operations) from
// one n-entry table of roots of unity, and the mel sums only each filter's
// nonzero bins (2*nnz operations, not 2*M*kmax).
//
// The C interface is loaded with ctypes (ops/cuda/ct_mel.py): it launches on
// the caller's stream, allocates nothing and returns the CUDA error code.

#include <cuda_runtime.h>

#include "fft_regs.cuh"

namespace {

using namespace fft;

constexpr int kThreads = 256;

// ------------------------------------ path 2: Stockham in shared memory ----

// Shared memory in floats: per frame g of the block, two buffers of Nc
// complex values (n floats each), then the packed filterbank weights.  The
// power spectrum reuses the buffer the last stage did not write.
struct Layout {
  long long buf, per_frame, wts, total;
  __host__ __device__ Layout(int n, int g, int nnz) {
    buf = round4(n);
    per_frame = 2 * buf;
    wts = (long long)g * per_frame;
    total = wts + round4(nnz);
  }
};

__global__ void __launch_bounds__(kThreads, 3)
ct_mel_kernel(const float* __restrict__ sig, const float* __restrict__ win,
              const float2* __restrict__ tw, const float* __restrict__ wpack,
              const int* __restrict__ ranges, float* __restrict__ out,
              long long T, int F, long long n_frames, int hop, int n, int m_odd,
              int n4, int has2, int kmax, int nnz, int M, int G) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(n, G, nnz);
  float* wts = smem + lay.wts;
  const int nc = n / 2;
  // each frame g of the block has tpf = 256/G threads (G a power of two),
  // so no loop below divides by a run-time size
  const int tpf = kThreads / G;
  const int g = threadIdx.x / tpf;
  const int lt = threadIdx.x - g * tpf;
  const long long fr = (long long)blockIdx.x * G + g;
  const bool live = fr < n_frames;
  float2* const buf0 = reinterpret_cast<float2*>(smem + g * lay.per_frame);
  float2* const buf1 = reinterpret_cast<float2*>(smem + g * lay.per_frame + lay.buf);
  auto bufs = [&](int s) { return s ? buf1 : buf0; };

  // z[t] = xw[2t] + i xw[2t+1]; a frame past the end is zeros (never written)
  if (live) {
    const long long b = fr / F;
    const float* x = sig + b * T + (fr - b * F) * hop;
    for (int t = lt; t < nc; t += tpf)
      buf0[t] = make_float2(__ldg(x + 2 * t) * __ldg(win + 2 * t),
                               __ldg(x + 2 * t + 1) * __ldg(win + 2 * t + 1));
  } else {
    for (int t = lt; t < nc; t += tpf) buf0[t] = make_float2(0.f, 0.f);
  }
  for (int i = threadIdx.x; i < nnz; i += kThreads) wts[i] = __ldg(wpack + i);
  __syncthreads();

  // Stockham stages (fft_stages.cuh), a block barrier after each
  const int src = fft::stockham(buf0, buf1, tw, nc, n, m_odd, n4, has2, lt, tpf,
                                fft::BlockSync{});

  // real split and power of the kmax bins the filterbank needs, into the
  // free buffer
  {
    const float2* z = bufs(src);
    float* pw = reinterpret_cast<float*>(bufs(src ^ 1));
    for (int k = lt; k < kmax; k += tpf) {
      const float2 x = fft::real_split([z](int i) { return z[i]; }, k, nc, tw);
      pw[k] = fmaf(x.x, x.x, x.y * x.y);
    }
  }
  __syncthreads();

  // mel: each filter over its nonzero bins only
  if (live) {
    const float* pw = reinterpret_cast<const float*>(bufs(src ^ 1));
    for (int m = lt; m < M; m += tpf) {
      const int lo = __ldg(ranges + 3 * m);
      const int hi = __ldg(ranges + 3 * m + 1);
      const float* w = wts + __ldg(ranges + 3 * m + 2) - lo;
      float acc = 0.f;
      for (int k = lo; k < hi; ++k) acc = fmaf(w[k], pw[k], acc);
      out[fr * M + m] = acc;
    }
  }
}

// ------------------------------------- path 1: register FFT per warp ----
constexpr int kTileF = 16;    // frames of a path-1 tile

// nc = n/2 is a power of two from 64 to 1024
inline bool path1_size(int n) {
  const int nc = n / 2;
  return n % 2 == 0 && nc >= 64 && nc <= 1024 && (nc & (nc - 1)) == 0;
}

// Shared memory in floats: two slabs of a tile's (kTileF-1)*hop + n samples
// (each with 3 floats of room for the alignment shift), the window, the
// packed weights, the ranges (ints), then each warp's scratch, per frame of
// the warp: the re and im exchange buffers and the power spectrum of the
// kmax bins, which at nc = 1024 reuses re (Z ends in registers there).
struct Layout1 {
  long long slab, win, wts, rng, warp, frame, per_warp, total;
  __host__ __device__ Layout1(int n, int hop, int kmax, int nnz, int m, int warps) {
    const int nc = n / 2;
    slab = round4((long long)(kTileF - 1) * hop + n + 3);
    win = 2 * slab;
    wts = win + round4(n);
    rng = wts + round4(nnz);
    warp = rng + round4(3LL * m);
    frame = nc == 1024 ? 2 * round4(xpad<1024>(nc)) : 2 * round4(pad8(nc)) + round4(kmax);
    per_warp = (32 / lanes_per_frame(nc)) * frame;
    total = warp + (long long)warps * per_warp;
  }
};

// Path 1's warps a block: the most of 8, 4, 2, 1 whose block fits (the slab
// grows with the hop); 0 where n is no path-1 size or not even one warp
// fits, and then the kernel takes path 2.
inline int path1_warps(int n, int hop, int kmax, int nnz, int m) {
  if (!path1_size(n)) return 0;
  return most_warps([&](int w) { return Layout1(n, hop, kmax, nnz, m, w).total * 4; }, kMaxSmem);
}

inline int ct_path(int n, int hop, int kmax, int nnz, int m) {
  return path1_warps(n, hop, kmax, nnz, m) ? 1 : 2;
}

struct Args {
  const float* sig;      // (B, T) centre-padded
  const float* win;      // (n,)
  const float2* tw;      // (n,) (cos, sin)(2 pi j / n)
  const float* wpack;    // (nnz,) each filter's weights over [lo, hi)
  const int* ranges;     // (M, 3) lo, hi, offset into wpack
  float* out;            // (B, F, M)
  long long T, n_tiles;
  int F, tiles_per_row, hop, n, kmax, nnz, M;
};

// The frames of a tile: warp w's frame groups take frames w*FPW + g, then
// every nw*FPW further (the same count for every lane of the warp).  Frames
// past F run on the slab's zeros and are not written.
template <int NC>
__device__ __forceinline__ void tile_path1(const Args& A, const float* slab, const float* win,
                                           float* scratch, long long frame_floats,
                                           const float* wts, const int* rng, int f0,
                                           float* out_row, int warp, int lane, int nw) {
  using Q = P1<NC>;
  const int g = lane / Q::TPF;
  const int lt = lane - g * Q::TPF;
  float* re = scratch + g * frame_floats;
  float* im = re + Q::BUF;
  float* pw = NC == 1024 ? re : im + Q::BUF;
  // nc = 1024: the complex values W_nc^lt, W_nc^{8 lt} (pass_last) and W_n^lt
  float2 w1{}, w8{}, wl{};
  if constexpr (NC == 1024) {
    const float2 t1 = __ldg(A.tw + 2 * lt), t8 = __ldg(A.tw + 16 * lt), tl = __ldg(A.tw + lt);
    w1 = make_float2(t1.x, -t1.y);
    w8 = make_float2(t8.x, -t8.y);
    wl = make_float2(tl.x, -tl.y);
  }
  const float2* win2 = reinterpret_cast<const float2*>(win);
  for (int s = warp * Q::FPW + g; s < kTileF; s += nw * Q::FPW) {
    const float* x = slab + s * A.hop;
    float2 a[Q::P];
    if (((uintptr_t)x & 7) == 0) {  // the frame starts on an even offset
      const float2* x2 = reinterpret_cast<const float2*>(x);
#pragma unroll
      for (int q = 0; q < Q::P; ++q) {
        const int t = lt + Q::TPF * q;
        const float2 v = x2[t], w = win2[t];
        a[q] = make_float2(v.x * w.x, v.y * w.y);
      }
    } else {
#pragma unroll
      for (int q = 0; q < Q::P; ++q) {
        const int t = lt + Q::TPF * q;
        const float2 w = win2[t];
        a[q] = make_float2(x[2 * t] * w.x, x[2 * t + 1] * w.y);
      }
    }
    if constexpr (NC == 1024) {
      fft_regs<NC>(a, re, im, A.tw, lt, w1, w8);
      // real split of bins k = lt + 32 j: Z[k] = a[j], Z[nc - k] by shuffle
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 zk = a[j];
        const float2 zm = split_partner(a, j, lt);
        const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
        const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
        const float2 X = fft::cadd(e, fft::cmul(o, fft::cmulw(wl, w64(j))));  // W_n^k
        const int k = lt + 32 * j;
        if (k < A.kmax) pw[k] = fmaf(X.x, X.x, X.y * X.y);
      }
      if (lt == 0 && A.kmax > NC) {  // X_{nc} = Re Z[0] - Im Z[0]
        const float X = a[0].x - a[0].y;
        pw[NC] = X * X;
      }
    } else {
      fft_regs<NC>(a, re, im, A.tw, lt);
      for (int k = lt; k < A.kmax; k += Q::TPF) {
        const float2 X = fft::real_split(
            [re, im](int i) { return make_float2(re[xpad<NC>(i)], im[xpad<NC>(i)]); }, k, NC,
            A.tw);
        pw[k] = fmaf(X.x, X.x, X.y * X.y);
      }
    }
    __syncwarp();
    const int f = f0 + s;
    if (f < A.F) {
      float* o = out_row + (long long)f * A.M;
      for (int m = lt; m < A.M; m += Q::TPF) {
        const int lo = rng[3 * m], hi = rng[3 * m + 1];
        const float* w = wts + rng[3 * m + 2] - lo;
        float acc = 0.f;
        for (int k = lo; k < hi; ++k) acc = fmaf(w[k], pw[k], acc);
        o[m] = acc;
      }
    }
    __syncwarp();
  }
}

// The persistent tile loop of fft_regs.cuh over tiles of kTileF frames.
template <int NC>
__global__ void __launch_bounds__(kMaxWarps * 32, NC == 1024 ? 1 : 2)
ct_mel_fft_kernel(const Args A) {
  extern __shared__ __align__(16) float smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Layout1 lay(A.n, A.hop, A.kmax, A.nnz, A.M, nw);
  float* win = smem + lay.win;
  float* wts = smem + lay.wts;
  int* rng = reinterpret_cast<int*>(smem + lay.rng);
  float* scratch = smem + lay.warp + warp * lay.per_warp;
  for (int i = threadIdx.x; i < A.n; i += blockDim.x) win[i] = __ldg(A.win + i);
  for (int i = threadIdx.x; i < A.nnz; i += blockDim.x) wts[i] = __ldg(A.wpack + i);
  for (int i = threadIdx.x; i < 3 * A.M; i += blockDim.x) rng[i] = __ldg(A.ranges + i);
  tile_loop(smem, lay.slab, A.sig, A.T, A.n_tiles, A.tiles_per_row, kTileF, A.hop,
            (kTileF - 1) * A.hop + A.n, [&](const float* slab, long long b, int f0) {
              tile_path1<NC>(A, slab, win, scratch, lay.frame, wts, rng, f0,
                             A.out + b * A.F * A.M, warp, lane, nw);
            });
}

// ------------------------------------------------------------ host side ----
// Launch shape.  Path 1: path1_warps warps, a persistent grid of every
// resident block.  Path 2: 256 threads, G frames a block, one block per G
// frames.  The occupancy query behind blocks_per_sm runs once per shape
// (residency in fft_regs.cuh).
cudaError_t make_plan(Plan& p, int n, int hop, int kmax, int nnz, int m, int B, int F, int G) {
  p.warps = path1_warps(n, hop, kmax, nnz, m);
  p.path = p.warps ? 1 : 2;
  if (p.path == 2) {
    p.warps = kThreads / 32;
    p.smem = Layout(n, G, nnz).total * (long long)sizeof(float);
    p.grid = ((long long)B * F + G - 1) / G;
    if (p.smem > kMaxSmem) return cudaErrorInvalidValue;
    int sms = 0;
    return residency(ct_mel_kernel, p.warps, p.smem, p.blocks_per_sm, sms);
  }
  p.smem = Layout1(n, hop, kmax, nnz, m, p.warps).total * (long long)sizeof(float);
  const long long n_tiles = (long long)B * ((F + kTileF - 1) / kTileF);
  switch (n / 2) {
    case 64: return persistent_grid(p, ct_mel_fft_kernel<64>, n_tiles);
    case 128: return persistent_grid(p, ct_mel_fft_kernel<128>, n_tiles);
    case 256: return persistent_grid(p, ct_mel_fft_kernel<256>, n_tiles);
    case 512: return persistent_grid(p, ct_mel_fft_kernel<512>, n_tiles);
    default: return persistent_grid(p, ct_mel_fft_kernel<1024>, n_tiles);
  }
}

template <int NC>
cudaError_t launch1(const Args& A, const Plan& p, cudaStream_t stream) {
  ct_mel_fft_kernel<NC><<<(unsigned)p.grid, p.warps * 32, (size_t)p.smem, stream>>>(A);
  return cudaGetLastError();
}

}  // namespace

// Path 2's shared memory for G frames a block.
extern "C" long long ct_mel_smem_bytes(int n, int g, int nnz) {
  return Layout(n, g, nnz).total * (long long)sizeof(float);
}

// Path 1's shared memory for a block of warps.
extern "C" long long ct_mel_fft_smem_bytes(int n, int hop, int kmax, int nnz, int m, int warps) {
  return Layout1(n, hop, kmax, nnz, m, warps).total * (long long)sizeof(float);
}

extern "C" int ct_mel_path(int n, int hop, int kmax, int nnz, int m) {
  return ct_path(n, hop, kmax, nnz, m);
}

// The launch shape for (B, F) frames on the current device: info = (path,
// warps, shared bytes, blocks per SM, grid).  Returns a cudaError_t.
extern "C" int ct_mel_plan(int n, int hop, int kmax, int nnz, int M, int B, int F, int G,
                           long long* info) {
  if (B <= 0 || F <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = make_plan(p, n, hop, kmax, nnz, M, B, F, G);
  if (e != cudaSuccess) return (int)e;
  info[0] = p.path;
  info[1] = p.warps;
  info[2] = p.smem;
  info[3] = p.blocks_per_sm;
  info[4] = p.grid;
  return 0;
}

// sig (B, T) centre-padded, win (n,), tw (n, 2) = (cos, sin)(2 pi j / n),
// wpack (nnz,) each filter's nonzero weights in turn, ranges (M, 3) int32
// (lo, hi, offset into wpack) with hi <= kmax <= n/2 + 1, out (B, F, M):
// contiguous on the current device.  n/2 = m_odd * 4^n4 * 2^has2 with
// m_odd odd (path 2's stages); G, a power of two, is path 2's frames a
// block.  Returns a cudaError_t.
extern "C" int ct_mel_launch(const float* sig, const float* win, const float* tw,
                             const float* wpack, const int* ranges, float* out, int B,
                             long long T, int F, int hop, int n, int m_odd, int n4,
                             int has2, int kmax, int nnz, int M, int G, void* stream) {
  long long prod = m_odd;
  for (int s = 0; s < n4; ++s) prod *= 4;
  if (has2) prod *= 2;
  const long long n_frames = (long long)B * F;
  const long long blocks = (n_frames + G - 1) / G;
  if (B <= 0 || F <= 0 || G <= 0 || hop <= 0 || n % 2 || m_odd % 2 == 0 ||
      prod != n / 2 || kmax > n / 2 + 1 || nnz < 0 || M <= 0 ||
      (long long)(F - 1) * hop + n > T || G > kThreads || (G & (G - 1)) ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Plan p;
  cudaError_t e = make_plan(p, n, hop, kmax, nnz, M, B, F, G);
  if (e != cudaSuccess) return (int)e;
  if (p.path == 2) {
    ct_mel_kernel<<<(unsigned)p.grid, kThreads, (size_t)p.smem, st>>>(
        sig, win, reinterpret_cast<const float2*>(tw), wpack, ranges, out, T, F, n_frames,
        hop, n, m_odd, n4, has2, kmax, nnz, M, G);
    return (int)cudaGetLastError();
  }
  Args A;
  A.sig = sig;
  A.win = win;
  A.tw = reinterpret_cast<const float2*>(tw);
  A.wpack = wpack;
  A.ranges = ranges;
  A.out = out;
  A.T = T;
  A.F = F;
  A.tiles_per_row = (F + kTileF - 1) / kTileF;
  A.n_tiles = (long long)B * A.tiles_per_row;
  A.hop = hop;
  A.n = n;
  A.kmax = kmax;
  A.nnz = nnz;
  A.M = M;
  switch (n / 2) {
    case 64: return (int)launch1<64>(A, p, st);
    case 128: return (int)launch1<128>(A, p, st);
    case 256: return (int)launch1<256>(A, p, st);
    case 512: return (int)launch1<512>(A, p, st);
    default: return (int)launch1<1024>(A, p, st);
  }
}

extern "C" const char* ct_mel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
