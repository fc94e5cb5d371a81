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
// split (X[k] = E[k] + W_n^k O[k], E and O from Z[k] and conj Z[Nc-k]).  The
// complex FFT is Stockham's self-sorting Cooley-Tukey: radix-4 stages, one
// radix-2 stage when log2 of the power-of-two part is odd, then one direct
// DFT stage for the odd part m of Nc (none when Nc is a power of two), each
// stage reading one buffer of shared memory and writing the other.  The
// stages and the split live in fft_stages.cuh, which speechpy_mfcc.cu shares.
//
// What bounds it.  At the librosa main path (n 2048, 128 slaney mels) the
// FFT is ~45 kFLOP a frame, the split, power and sparse projection ~25 kFLOP
// more, against 8 KB of samples read (4 frames share each one at hop 512)
// and 512 B written.  The operation bound is still above the byte bound, but
// what the kernel actually waits on is shared memory: each radix-4
// butterfly moves 8 complex values through it for 34 FLOP.  So:
//
// * Operations first.  The TPU kernel factors n = 128 x 16 to fill the
//   MXU and spends ~1 MFLOP a frame on twiddle-folded stage-2 GEMMs whose
//   constants (1.97 MB) it keeps in VMEM; a block here would reread them
//   from L2 for every tile.  A radix-4 FFT does ~20x fewer operations and
//   needs one n-entry table of roots of unity (16 KB at n 2048), read
//   through the read-only cache: no constant matrix at all.
// * No VMEM-resident row.  Blocks run in any order, so each block takes G
//   consecutive frames of the flattened (B, F) frame list and reads each
//   frame's n samples itself at f*hop (coalesced; overlapping frames hit
//   L2).  Every hop works alike, 512, 160, 130 or 768: there is no chunk
//   layout and no frame gather outside the kernel.
// * Sparse projection.  A slaney filter touches a few dozen bins, so mel
//   sums only [lo_m, hi_m): 2*nnz(fb) operations, not 2*M*kmax, and the
//   split computes only the kmax bins the filterbank needs.  The nonzero
//   weights come packed (8 KB at n 2048) and sit in shared memory: read
//   from the dense bank in global memory, the 32 lanes of a warp (32
//   filters) would touch 32 sectors a load, ~2 GB of L2 traffic a call.
// * Shared memory is two Nc-entry complex buffers per frame (16 KB at n
//   2048) and the packed weights; the host picks G (<= 8) so that three
//   blocks fit on an SM and the L1 keeps room for the table and window.
//
// Work mapping: 256 threads, 256/G of them on each frame of the block, a
// block barrier between stages.
//
// The C interface is loaded with ctypes (ops/cuda/ct_mel.py): it launches on
// the caller's stream, allocates nothing and returns the CUDA error code.

#include <cuda_runtime.h>

#include "fft_stages.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, the per-block limit

__host__ __device__ inline long long round4(long long n) { return (n + 3) / 4 * 4; }

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

}  // namespace

extern "C" long long ct_mel_smem_bytes(int n, int g, int nnz) {
  return Layout(n, g, nnz).total * (long long)sizeof(float);
}

// sig (B, T) centre-padded, win (n,), tw (n, 2) = (cos, sin)(2 pi j / n),
// wpack (nnz,) each filter's nonzero weights in turn, ranges (M, 3) int32
// (lo, hi, offset into wpack) with hi <= kmax <= n/2 + 1, out (B, F, M):
// contiguous on the current device.  n/2 = m_odd * 4^n4 * 2^has2 with
// m_odd odd; G a power of two.  Returns a cudaError_t.
extern "C" int ct_mel_launch(const float* sig, const float* win, const float* tw,
                             const float* wpack, const int* ranges, float* out, int B,
                             long long T, int F, int hop, int n, int m_odd, int n4,
                             int has2, int kmax, int nnz, int M, int G, void* stream) {
  long long prod = m_odd;
  for (int s = 0; s < n4; ++s) prod *= 4;
  if (has2) prod *= 2;
  const long long smem = ct_mel_smem_bytes(n, G, nnz);
  const long long n_frames = (long long)B * F;
  const long long blocks = (n_frames + G - 1) / G;
  if (smem > kMaxSmem || B <= 0 || F <= 0 || G <= 0 || n % 2 || m_odd % 2 == 0 ||
      prod != n / 2 || kmax > n / 2 + 1 || nnz < 0 || (long long)(F - 1) * hop + n > T ||
      G > kThreads || (G & (G - 1)) ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ct_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ct_mel_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      sig, win, reinterpret_cast<const float2*>(tw), wpack, ranges, out, T, F, n_frames,
      hop, n, m_odd, n4, has2, kmax, nnz, M, G);
  return (int)cudaGetLastError();
}

extern "C" const char* ct_mel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
