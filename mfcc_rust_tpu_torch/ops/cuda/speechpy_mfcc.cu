// Fused speechpy MFCC for Hopper (sm_90a), plain FP32.
//
// Replaces the TPU kernel mfcc_rust_tpu/ops/pallas/speechpy_mfcc.py
// (mfcc_pallas / _kernel).  Same lowering: the frame matrix is never built;
// frame f of a hop-chunked signal is the contiguous run of r*hop samples
// starting at f*hop, so
//
//   y   = big @ wall            wall = [C_trim | S_trim | w | ±w]  (K x W)
//   s2  = sum(big^2 over the first fl samples)          (Parseval, emask)
//   P   = (y*y) @ proj          proj = [fb/N | e-select]          (W x M+1)
//   en  = (N*s2 + P[:, M]) / 2N
//   out = log(zh(P[:, :M])) @ dct,  out[:, 0] = log(zh(en)) with dc_elim
//
// What bounds it: the chunk GEMM, 2*F*K*W operations per batch row (8.0
// GFLOP of the 9.0 at the B=48 x 10 s headline) against 30.7 MB read, so it
// is compute-bound in FP32.  The design keeps every intermediate (y, y*y,
// P, the logs) in shared memory and writes only the (B, F, C) answer.
//
// Layout.  The TPU kernel holds a whole chunk row per batch element in
// VMEM (640 KB at 10 s), which does not fit in shared memory, so the frame
// axis is tiled instead: one block per (tile of TF frames, batch row),
// staging (TF + r - 1)*hop samples, which includes the r-1 chunk halo.
// 8 warps; warp w owns frames 8w..8w+7 of the tile, lane l owns columns
// l + 32j (j < 9) of a 288-column pass over W, so the signal operand is a
// warp-wide broadcast from shared memory and the wall operand a
// conflict-free row read.  The wall streams through shared memory KT rows
// at a time.  W > 288 takes several passes, each adding its share of P.
// Each warp projects its own frames' y*y onto P, so the projection needs no
// block-wide barrier; when one pass covers W, y*y reuses the space of the
// signal and wall tiles, which keeps a block near 90 KB at the default
// config and lets two blocks (16 warps) share an SM.
//
// The C interface is loaded with ctypes (ops/cuda/speechpy_mfcc.py): it
// launches on the caller's stream, allocates nothing and returns the CUDA
// error code of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kFramesPerWarp = 8;
constexpr int kTileF = kWarps * kFramesPerWarp;  // frames per block
constexpr int kColsPerLane = 9;
constexpr int kPassW = 32 * kColsPerLane;  // wall columns per pass
constexpr int kTileK = 32;                 // wall rows staged per step
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 232448;           // 227 KB, the per-block limit

__host__ __device__ inline long long round4(long long n) { return (n + 3) / 4 * 4; }

// Shared-memory layout in floats: [slab | wall tile] (or y*y over both when
// one pass covers W), then y*y of a pass (several passes), P, s2.
struct Layout {
  long long slab, ysq, pacc, s2, total;
  __host__ __device__ Layout(int hop, int r, int m, int w) {
    const long long slab_len = round4((long long)(kTileF + r - 1) * hop);
    const long long stage = slab_len + (long long)kTileK * kPassW;
    const long long ysq_len = (long long)kTileF * kPassW;
    slab = 0;
    long long body;
    if (w <= kPassW) {
      ysq = 0;
      body = stage > ysq_len ? stage : ysq_len;
    } else {
      ysq = stage;
      body = stage + ysq_len;
    }
    pacc = body;
    s2 = pacc + round4((long long)kTileF * (m + 1));
    total = s2 + kTileF;
  }
};

__global__ void __launch_bounds__(kThreads, 2)
mfcc_fused_kernel(const float* __restrict__ sig, const float* __restrict__ wall,
                  const float* __restrict__ proj, const float* __restrict__ dct,
                  float* __restrict__ out, long long T, int F, int hop, int r,
                  int fl, int W, int M, int C, int n_fft, int dc_elim,
                  float eps) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay(hop, r, M, W);
  const int K = r * hop;
  const int M1 = M + 1;
  const int slab_len = (kTileF + r - 1) * hop;
  float* slab = smem + lay.slab;           // (TF + r - 1) * hop samples
  float* wt = slab + round4(slab_len);     // kTileK x kPassW wall rows
  float* ysq = smem + lay.ysq;             // per warp: kPassW x 8 frames
  float* pacc = smem + lay.pacc;           // TF x (M+1), P
  float* s2 = smem + lay.s2;               // TF, sum of squares

  const int n_tiles = (F + kTileF - 1) / kTileF;
  const int b = blockIdx.x / n_tiles;
  const int f0 = (blockIdx.x - b * n_tiles) * kTileF;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long start = (long long)f0 * hop;
  const float* x = sig + (long long)b * T + start;
  const long long avail = T - start;

  // samples past the end of the signal read as zeros: they only reach
  // frames past F (not written) or zero wall rows (hop-misaligned frames)
  for (int i = tid; i < slab_len; i += kThreads) slab[i] = i < avail ? __ldg(x + i) : 0.f;
  for (int i = tid; i < kTileF * M1; i += kThreads) pacc[i] = 0.f;
  __syncthreads();

  // Parseval term: the first fl samples of each frame only (emask), so the
  // zero wall rows of hop-misaligned frames add nothing
  for (int i = 0; i < kFramesPerWarp; ++i) {
    const int f = warp * kFramesPerWarp + i;
    const float* fr = slab + f * hop;
    float acc = 0.f;
    for (int k = lane; k < fl; k += 32) acc = fmaf(fr[k], fr[k], acc);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) s2[f] = acc;
  }

  const float* xw = slab + warp * kFramesPerWarp * hop;
  float* yw = ysq + warp * kFramesPerWarp * kPassW;  // this warp's y*y
  for (int c0 = 0; c0 < W; c0 += kPassW) {
    float acc[kFramesPerWarp][kColsPerLane];
#pragma unroll
    for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kTileK) {
      const int kn = min(kTileK, K - k0);
      __syncthreads();  // the previous wall tile is consumed
      for (int kk = warp; kk < kTileK; kk += kWarps) {
        float* dst = wt + kk * kPassW;
        for (int c = lane; c < kPassW; c += 32)
          dst[c] = (kk < kn && c0 + c < W)
                       ? __ldg(wall + (long long)(k0 + kk) * W + c0 + c)
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        float a[kFramesPerWarp];
        float w[kColsPerLane];
#pragma unroll
        for (int i = 0; i < kFramesPerWarp; ++i) a[i] = xw[i * hop + k0 + kk];
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) w[j] = wt[kk * kPassW + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kFramesPerWarp; ++i)
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    // y*y of this pass, column-major over the warp's 8 frames; columns past
    // W are zero (their wall columns were).  With one pass it overwrites
    // the signal and wall tiles, so every warp must be done with them.
    if (W <= kPassW) __syncthreads();
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      float* d = yw + (lane + 32 * j) * kFramesPerWarp;
      *reinterpret_cast<float4*>(d) =
          make_float4(acc[0][j] * acc[0][j], acc[1][j] * acc[1][j],
                      acc[2][j] * acc[2][j], acc[3][j] * acc[3][j]);
      *reinterpret_cast<float4*>(d + 4) =
          make_float4(acc[4][j] * acc[4][j], acc[5][j] * acc[5][j],
                      acc[6][j] * acc[6][j], acc[7][j] * acc[7][j]);
    }
    __syncwarp();
    // P[warp's frames, j] += (y*y) @ proj over this pass's columns; lane l
    // owns the P columns l and l + 32 (M + 1 <= 64) or loops for more
    const int wn = min(kPassW, W - c0);
    for (int j0 = 0; j0 < M1; j0 += 64) {
      const int ja = j0 + lane;
      const int jb = j0 + 32 + lane;
      const bool oka = ja < M1;
      const bool okb = jb < M1;
      float pa[kFramesPerWarp], pb[kFramesPerWarp];
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) pa[i] = pb[i] = 0.f;
      const float* pr = proj + (long long)c0 * M1;
#pragma unroll 2
      for (int c = 0; c < wn; ++c) {
        const float va = oka ? __ldg(pr + (long long)c * M1 + ja) : 0.f;
        const float vb = okb ? __ldg(pr + (long long)c * M1 + jb) : 0.f;
        const float4 y0 = *reinterpret_cast<const float4*>(yw + c * kFramesPerWarp);
        const float4 y1 = *reinterpret_cast<const float4*>(yw + c * kFramesPerWarp + 4);
        const float yv[kFramesPerWarp] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int i = 0; i < kFramesPerWarp; ++i) {
          pa[i] = fmaf(yv[i], va, pa[i]);
          pb[i] = fmaf(yv[i], vb, pb[i]);
        }
      }
      float* prow = pacc + warp * kFramesPerWarp * M1;
#pragma unroll
      for (int i = 0; i < kFramesPerWarp; ++i) {
        if (oka) prow[i * M1 + ja] += pa[i];
        if (okb) prow[i * M1 + jb] += pb[i];
      }
    }
  }
  __syncthreads();

  // zero handling (f32 epsilon) and log of the mel energies, in place
  for (int o = tid; o < kTileF * M; o += kThreads) {
    const int f = o / M;
    const int m = o - f * M;
    const float v = pacc[f * M1 + m];
    pacc[f * M1 + m] = logf(v == 0.f ? eps : v);
  }
  __syncthreads();

  // DCT-II ortho M -> C, and log frame energy into column 0 (dc_elim)
  const float inv2n = 1.f / (2.f * (float)n_fft);
  for (int o = tid; o < kTileF * C; o += kThreads) {
    const int f = o / C;
    const int c = o - f * C;
    if (f0 + f >= F) continue;
    const float* lm = pacc + f * M1;
    float v;
    if (dc_elim && c == 0) {
      const float en = ((float)n_fft * s2[f] + lm[M]) * inv2n;
      v = logf(en == 0.f ? eps : en);
    } else {
      v = 0.f;
      for (int m = 0; m < M; ++m) v = fmaf(lm[m], __ldg(dct + m * C + c), v);
    }
    out[((long long)b * F + f0 + f) * C + c] = v;
  }
}

}  // namespace

extern "C" long long mfcc_fused_smem_bytes(int hop, int r, int m, int w) {
  return Layout(hop, r, m, w).total * (long long)sizeof(float);
}

// sig (B, T), wall (r*hop, W), proj (W, M+1), dct (M, C), out (B, F, C):
// contiguous float32 on the current device.  Returns a cudaError_t.
extern "C" int mfcc_fused_launch(const float* sig, const float* wall,
                                 const float* proj, const float* dct,
                                 float* out, int B, long long T, int F,
                                 int hop, int r, int fl, int W, int M, int C,
                                 int n_fft, int dc_elim, float eps,
                                 void* stream) {
  const long long smem = mfcc_fused_smem_bytes(hop, r, M, W);
  const long long blocks = (long long)B * ((F + kTileF - 1) / kTileF);
  if (smem > kMaxSmem || B <= 0 || F <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mfcc_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  mfcc_fused_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      sig, wall, proj, dct, out, T, F, hop, r, fl, W, M, C, n_fft, dc_elim, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* mfcc_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
