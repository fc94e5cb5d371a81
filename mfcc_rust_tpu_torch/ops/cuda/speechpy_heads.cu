// The speechpy heads of every frame of the chunk-GEMM product in one pass
// (features._extract_heads): mel energies, frame energy, log-mel, SSC and
// MFCC, each written once.
//
// Replaces no TPU kernel: the JAX package computes these heads as separate
// XLA operations after its wall product, and the port did the same in
// PyTorch (features._extract_heads_plain): several full passes over the
// (rows, frames, 2 kmax + 2) product and three small products.  The heads
// need 134 floats a frame out of the product's 260 in (speechpy defaults),
// under one operation a byte, so bytes bind the kernel on this card; its
// design reads each product row and each frame's samples once and keeps
// every intermediate in shared memory and registers.
//
// One warp takes kFrames consecutive frames at once, over a persistent
// grid: it stages their rows [C_trim | S_trim | w | +-w] (X_0 and X_{N/2}
// already exact, by speechpy_edges.cu), back to back in y, in its own slice
// of shared memory (float4 loads where the rows allow), and sums x^2 w^2
// over each frame's fl samples (the L2 serves the half that the
// neighbouring frame shares).  It
// turns each row into |X_k|^2 and the SSC's power (|X_k|^2 / N, an exact
// zero taken as the float64 epsilon) in place.  Then lanes take mel bands,
// each band for all kFrames frames, its weights read once: the mel, SSC
// numerator and denominator over the band's nonzero bins only, from weights
// staged once a block.  The bands come in an order that evens the bins a
// lane sums (the host's schedule: the widest bands share no lane).  Then the
// log of each band, the DCT over the logs, and with dc_elimination the log
// frame energy in cepstrum 0.  A warp syncs only with itself: the block's
// one barrier is after the constants are staged.
//
// Every sum is float32 IEEE with the plain version's weights (no TF32);
// only the order of each sum differs from the plain version's products.
#include <cuda_runtime.h>
#include <math.h>

#include "fft_regs.cuh"  // fft::persistent_grid, fft::kMaxSmem

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kEps32 = 1.1920928955078125e-07f;  // zero_handling's float32 epsilon
constexpr float kSscEps = 2.220446049250313e-16f;  // the SSC's zero bins: float64 epsilon

enum Head { kMfe = 1, kEnergy = 2, kLmfe = 4, kSsc = 8, kMfcc = 16 };

struct Args {
  const float* y;       // (total, W) product rows
  const float* x;       // samples: frame f of row b starts at x + b * x_row + f * hop
  long long x_row;
  const float* consts;  // wmel, wnum, wden (nnz each), dct (M, C), w2 (fl)
  const int* sched;     // (M, 4) the bands in lane order: lo, hi, weight offset, band
  float* mel;           // (total, M), or null
  float* energy;        // (total,), or null
  float* lmfe;          // (total, M), or null
  float* ssc;           // (total, M), or null
  float* mfcc;          // (total, C), or null
  long long total;      // rows * frames
  int frames, W, kmax, nnz, M, C, fl, hop, heads, need_energy, dc_elim;
  float n;  // fft points
};

constexpr int kFrames = 4;  // frames a warp takes at once: one float4 of band logs
static_assert(kFrames == 4, "a band's logs are one float4");

__host__ __device__ inline int round4(int v) { return static_cast<int>(fft::round4(v)); }

__host__ __device__ inline int const_floats(int nnz, int m, int c, int fl) {
  return 3 * nnz + m * c + fl;
}

// floats of one warp's slice: kFrames rows, then the band logs (M, kFrames)
__host__ __device__ inline int warp_floats(int w, int m) { return kFrames * (round4(w) + m); }

int smem_bytes(int w, int nnz, int m, int c, int fl) {
  return 4 * (round4(const_floats(nnz, m, c, fl) + 4 * m) + kWarpsPerBlock * warp_floats(w, m));
}

template <bool kVec4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) speechpy_heads_kernel(const Args A) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int nconst = const_floats(A.nnz, A.M, A.C, A.fl);
  const float* wmel = sm;
  const float* wnum = wmel + A.nnz;
  const float* wden = wnum + A.nnz;
  const float* dct = wden + A.nnz;
  const float* w2 = dct + A.M * A.C;
  int* sched = reinterpret_cast<int*>(sm + nconst);
  for (int i = threadIdx.x; i < nconst; i += blockDim.x) sm[i] = __ldg(A.consts + i);
  for (int i = threadIdx.x; i < 4 * A.M; i += blockDim.x) sched[i] = __ldg(A.sched + i);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int ws = round4(A.W);  // a row's stride in the slice
  float* rows = sm + round4(nconst + 4 * A.M) + wib * warp_floats(A.W, A.M);
  float4* logs = reinterpret_cast<float4*>(rows + kFrames * ws);  // band m: its kFrames logs
  const int kmax = A.kmax;
  const float n = A.n;
  const float inv_n = 1.0f / n;
  const bool mel_logs = A.heads & (kLmfe | kMfcc);
  const bool ssc = A.heads & kSsc;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock * kFrames;

  for (long long g0 = (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + wib) * kFrames;
       g0 < A.total; g0 += stride) {
    // frames g0 .. g0 + nf - 1; a slot past them computes on stale rows and
    // writes nothing
    const int nf = A.total - g0 < kFrames ? static_cast<int>(A.total - g0) : kFrames;
    const float* yg = A.y + g0 * A.W;
    if (kVec4) {  // W == ws: the rows lie back to back in y and in the slice
      const float4* y4 = reinterpret_cast<const float4*>(yg);
      float4* r4 = reinterpret_cast<float4*>(rows);
      const int n4 = nf * A.W / 4;
      for (int i = lane; i < n4; i += 32) r4[i] = __ldcs(y4 + i);  // read once: streamed
    } else {
      const int nw = nf * A.W;
      for (int i = lane; i < nw; i += 32) {
        const int f = i / A.W;
        rows[f * ws + i - f * A.W] = __ldcs(yg + i);
      }
    }
    float s2[kFrames];  // sum of x^2 w^2 over each frame
#pragma unroll
    for (int f = 0; f < kFrames; ++f) s2[f] = 0.0f;
    if (A.need_energy) {
      const float* xf[kFrames];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const long long g = g0 + (f < nf ? f : 0);
        const long long b = g / A.frames;
        xf[f] = A.x + b * A.x_row + (g - b * A.frames) * A.hop;
      }
      for (int t = lane; t < A.fl; t += 32) {
        const float wt = w2[t];
#pragma unroll
        for (int f = 0; f < kFrames; ++f) {
          const float v = __ldg(xf[f] + t);
          s2[f] = fmaf(__fmul_rn(v, v), wt, s2[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < kFrames; ++f)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s2[f] += __shfl_xor_sync(0xffffffffu, s2[f], o);
    }
    __syncwarp();
    // |X_k|^2 at k and the SSC's power at kmax + k; each lane reads and
    // writes only its own k and kmax + k of each row
    for (int k = lane; k < kmax; k += 32) {
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        float* r = rows + f * ws;
        const float c = r[k], s = r[kmax + k];
        const float q = __fadd_rn(__fmul_rn(c, c), __fmul_rn(s, s));
        const float p = __fmul_rn(q, inv_n);
        r[k] = q;
        r[kmax + k] = p == 0.0f ? kSscEps : p;
      }
    }
    __syncwarp();
    // Parseval: (N sum x^2 w^2 + X_0^2 + X_{N/2}^2) / 2N, zero-handled
    float e[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const float s0 = rows[f * ws + 2 * kmax], s1 = rows[f * ws + 2 * kmax + 1];
      e[f] = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(n, s2[f]), __fmul_rn(s0, s0)),
                                 __fmul_rn(s1, s1)),
                       2.0f * n);
      e[f] = e[f] == 0.0f ? kEps32 : e[f];
    }

    for (int j = lane; j < A.M; j += 32) {
      const int* sj = sched + 4 * j;
      const int lo = sj[0], hi = sj[1], off = sj[2] - lo, m = sj[3];
      float mel[kFrames], num[kFrames], den[kFrames];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) mel[f] = num[f] = den[f] = 0.0f;
      for (int k = lo; k < hi; ++k) {
        const float wm = wmel[off + k];
#pragma unroll
        for (int f = 0; f < kFrames; ++f) mel[f] = fmaf(wm, rows[f * ws + k], mel[f]);
        if (ssc) {
          const float wn = wnum[off + k], wd = wden[off + k];
#pragma unroll
          for (int f = 0; f < kFrames; ++f) {
            const float pz = rows[f * ws + kmax + k];
            num[f] = fmaf(wn, pz, num[f]);
            den[f] = fmaf(wd, pz, den[f]);
          }
        }
      }
      float l[kFrames];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        mel[f] = mel[f] == 0.0f ? kEps32 : mel[f];
        l[f] = mel_logs ? logf(mel[f]) : 0.0f;
        if (f < nf) {
          const long long o = (g0 + f) * A.M + m;
          if (A.heads & kMfe) A.mel[o] = mel[f];
          if (A.heads & kLmfe) A.lmfe[o] = l[f];
          if (ssc) A.ssc[o] = __fdiv_rn(num[f], den[f]);
        }
      }
      logs[m] = make_float4(l[0], l[1], l[2], l[3]);
    }
    __syncwarp();
    if (A.heads & kMfcc) {
      for (int c = lane; c < A.C; c += 32) {
        float acc[kFrames];
        if (c == 0 && A.dc_elim) {
#pragma unroll
          for (int f = 0; f < kFrames; ++f) acc[f] = logf(e[f]);
        } else {
#pragma unroll
          for (int f = 0; f < kFrames; ++f) acc[f] = 0.0f;
          for (int m = 0; m < A.M; ++m) {
            const float4 lv = logs[m];
            const float d = dct[m * A.C + c];
            acc[0] = fmaf(lv.x, d, acc[0]);
            acc[1] = fmaf(lv.y, d, acc[1]);
            acc[2] = fmaf(lv.z, d, acc[2]);
            acc[3] = fmaf(lv.w, d, acc[3]);
          }
        }
#pragma unroll
        for (int f = 0; f < kFrames; ++f)
          if (f < nf) A.mfcc[(g0 + f) * A.C + c] = acc[f];
      }
    }
    if (A.energy != nullptr) {
#pragma unroll
      for (int f = 0; f < kFrames; ++f)
        if (lane == f && f < nf) A.energy[g0 + f] = e[f];
    }
    __syncwarp();  // the next frames overwrite the rows and the logs
  }
}

// every block that is resident at once, at most one a kWarpsPerBlock * kFrames frames
template <bool kVec4>
int launch(const Args& A, int smem, cudaStream_t stream) {
  const auto kernel = speechpy_heads_kernel<kVec4>;
  const long long per_block = kWarpsPerBlock * kFrames;
  fft::Plan p{0, kWarpsPerBlock, 0, smem, 0};
  const cudaError_t err = fft::persistent_grid(p, kernel, (A.total + per_block - 1) / per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(p.grid), kWarpsPerBlock * 32, smem, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: the constants, the band schedule, and
// each warp's kFrames rows and band logs.
int speechpy_heads_smem_bytes(int w, int nnz, int m, int c, int fl) {
  return smem_bytes(w, nnz, m, c, fl);
}

// y: total = rows x frames contiguous rows of w floats (16-byte aligned rows
// when vec4); x: row b's samples at x + b * x_row, frame f from f * hop, fl
// of them; consts: wmel, wnum, wden (nnz each), dct (m, c), w2 (fl);
// sched (m, 4) int32, the bands in lane order (lo, hi, offset, band).  Each
// output pointer may be null where its head is not in heads.  Returns a
// cudaError_t.
int speechpy_heads_launch(const float* y, const float* x, long long x_row, const float* consts,
                          const int* sched, float* mel, float* energy, float* lmfe, float* ssc,
                          float* mfcc, long long rows, int frames, int w, int kmax, int nnz, int m,
                          int c, int fl, int hop, int n, int heads, int need_energy, int dc_elim,
                          int vec4, void* stream) {
  const long long total = rows * frames;
  if (total == 0) return 0;
  const int smem = smem_bytes(w, nnz, m, c, fl);
  if (smem > fft::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  Args A{y,    x,     x_row, consts, sched,  mel,         energy,     lmfe,
         ssc,  mfcc,  total, frames, w,      kmax,        nnz,        m,
         c,    fl,    hop,   heads,  need_energy, dc_elim, static_cast<float>(n)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec4 ? launch<true>(A, smem, s) : launch<false>(A, smem, s);
}

const char* speechpy_heads_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
