// Register-resident complex FFT for one warp, cp.async tile staging over a
// persistent grid and its launch planning, shared by speechpy_mfcc.cu (K1)
// and ct_mel.cu (K2).
//
// fft_regs<NC> transforms nc = NC points, a power of two from 64 to 1024.
// TPF = lanes_per_frame(NC) lanes of one warp own a frame; lane lt holds
// point lt + TPF*q in a[q], q < P = NC / TPF.  The passes are Stockham
// passes with the butterflies in registers; between two passes the points go
// through the frame's own bank-padded exchange buffers (re, im) under
// __syncwarp:
//
// * NC <= 512: radix 8, 8 and NC/64 (P = 8 or 16).  The last pass writes Z
//   in natural order to the buffers, where the caller reads it.
// * NC = 1024: radix 32, 32 (P = 32, one butterfly a lane a pass).  The
//   second pass keeps its outputs: lane lt ends with Z[lt + 32 r] in a[r],
//   so the caller can split the real FFT by shuffles (split_partner) and
//   the buffers are free again.  Its twiddles W_nc^{lt q} are products of
//   two per-lane values (pass_last), not table reads.
//
// Twiddles elsewhere come from one n = 2 nc entry table tw[j] = (cos, sin)
// (2 pi j / n), standing for W_n^j = cos - i sin, through the read-only cache.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "fft_stages.cuh"

namespace fft {

__host__ __device__ constexpr long long round4(long long n) { return (n + 3) / 4 * 4; }

// lanes of a path-1 frame
__host__ __device__ constexpr int lanes_per_frame(int nc) { return nc >= 256 ? 32 : nc / 8; }

// index into a path-1 exchange buffer: one float skipped every eight, so
// the scattered writes of a pass and the strided reads of the next spread
// over the banks
__host__ __device__ constexpr int pad8(int i) { return i + (i >> 3); }

// The exchange index of plan NC: pad8 for radix-8 passes; one float skipped
// every 32 for the radix-32 passes of NC = 1024, whose writes stride 32
// points a lane.
template <int NC>
__host__ __device__ constexpr int xpad(int i) { return NC == 1024 ? i + (i >> 5) : pad8(i); }

template <int NC>
struct P1 {
  static constexpr int TPF = lanes_per_frame(NC);
  static constexpr int P = NC / TPF;     // points a lane holds, 8, 16 or 32
  static constexpr int FPW = 32 / TPF;   // frames a warp holds at once
  static constexpr int BUF = (int)round4(xpad<NC>(NC));
};

// W_64^j = (cos, sin)(2 pi j / 64) for a j known at compile time once the
// loops around it unroll, 0 <= j < 64
__device__ __forceinline__ float2 w64(int j) {
  constexpr float c[17] = {1.0f, 0.9951847195625305f, 0.9807852506637573f, 0.9569403529167175f,
                           0.9238795042037964f, 0.8819212913513184f, 0.8314695954322815f,
                           0.7730104327201843f, 0.7071067690849304f, 0.6343932747840881f,
                           0.5555702447891235f, 0.4713967442512512f, 0.3826834261417389f,
                           0.290284663438797f, 0.19509032368659973f, 0.0980171412229538f, 0.0f};
  const int q = j & 15, h = j >> 4;  // j = 16 h + q: W_64^j = (-i)^h W_64^q
  const float2 w = make_float2(c[q], c[16 - q]);
  switch (h) {
    case 0: return w;
    case 1: return make_float2(-w.y, w.x);
    case 2: return make_float2(-w.x, -w.y);
    default: return make_float2(w.y, -w.x);
  }
}

// the complex product a b
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// a * W_64^j for j known at compile time
__device__ __forceinline__ float2 mulw64(float2 a, int j) {
  if (j == 0) return a;
  if (j == 16) return make_float2(a.y, -a.x);  // -i
  return cmulw(a, w64(j));
}

// in-place R-point DFT, natural order in and out
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = fft::cadd(a, v[1]);
    v[1] = fft::csub(a, v[1]);
  } else if constexpr (R == 4) {
    const float2 s0 = fft::cadd(v[0], v[2]), d0 = fft::csub(v[0], v[2]);
    const float2 s1 = fft::cadd(v[1], v[3]), d1 = fft::csub(v[1], v[3]);
    v[0] = fft::cadd(s0, s1);
    v[1] = make_float2(d0.x + d1.y, d0.y - d1.x);  // d0 - i d1
    v[2] = fft::csub(s0, s1);
    v[3] = make_float2(d0.x - d1.y, d0.y + d1.x);  // d0 + i d1
  } else if constexpr (R == 8) {
    float2 e[4] = {v[0], v[2], v[4], v[6]};
    float2 o[4] = {v[1], v[3], v[5], v[7]};
    dft<4>(e);
    dft<4>(o);
    const float c = 0.70710678118654752f;
    o[1] = make_float2((o[1].x + o[1].y) * c, (o[1].y - o[1].x) * c);   // W8
    o[2] = make_float2(o[2].y, -o[2].x);                                 // W8^2 = -i
    o[3] = make_float2((o[3].y - o[3].x) * c, -(o[3].x + o[3].y) * c);  // W8^3
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = fft::cadd(e[k], o[k]);
      v[k + 4] = fft::csub(e[k], o[k]);
    }
  } else {
    static_assert(R == 16 || R == 32, "radix 2, 4, 8, 16 or 32");
    // even and odd halves, then the W_R^k butterflies (W_R^k = W_64^{k 64/R})
    constexpr int H = R / 2;
    float2 e[H], o[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      e[k] = v[2 * k];
      o[k] = v[2 * k + 1];
    }
    dft<H>(e);
    dft<H>(o);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float2 t = mulw64(o[k], k * (64 / R));
      v[k] = fft::cadd(e[k], t);
      v[k + H] = fft::csub(e[k], t);
    }
  }
}

// One Stockham pass of radix R over sub-transforms of NS points.  Lane lt
// holds point lt + TPF*q in a[q] and runs the butterflies lt + TPF*u (u <
// P/R), whose inputs are all its own; outputs go to their Stockham places
// (b / NS) * NS * R + k + r * NS of the exchange buffers.
template <int NC, int R, int NS>
__device__ __forceinline__ void pass(float2 (&a)[P1<NC>::P], float* re, float* im,
                                     const float2* __restrict__ tw, int lt) {
  constexpr int TPF = P1<NC>::TPF, U = P1<NC>::P / R;
  constexpr int STEP = 2 * NC / (NS * R);  // W_{NS R}^{k q} = W_n^{k q STEP}
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = a[u + q * U];
    const int b = lt + TPF * u;
    const int k = b & (NS - 1);
    if constexpr (NS > 1) {
#pragma unroll
      for (int q = 1; q < R; ++q) v[q] = fft::cmulw(v[q], __ldg(tw + k * q * STEP));
    }
    dft<R>(v);
    const int base = (b - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = xpad<NC>(base + r * NS);
      re[i] = v[r].x;
      im[i] = v[r].y;
    }
  }
}

template <int NC>
__device__ __forceinline__ void gather(float2 (&a)[P1<NC>::P], const float* re, const float* im,
                                       int lt) {
#pragma unroll
  for (int q = 0; q < P1<NC>::P; ++q) {
    const int i = xpad<NC>(lt + P1<NC>::TPF * q);
    a[q] = make_float2(re[i], im[i]);
  }
}

// The last pass of NC = 1024 (radix 32 over sub-transforms of 32 points),
// outputs kept: lane lt's one butterfly is b = k = lt, so its twiddles are
// W_nc^{lt q} = w8^{q >> 3} w1^{q & 7} from the complex values w1 = W_nc^lt
// and w8 = W_nc^{8 lt} (at most ten products of two table values).
// Afterwards a[r] = Z[lt + 32 r].
__device__ __forceinline__ void pass_last(float2 (&a)[32], float2 w1, float2 w8) {
  float2 wb = make_float2(1.f, 0.f);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float2 w = wb;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (c || r) a[8 * c + r] = fft::cmul(a[8 * c + r], w);
      if (r < 7) w = fft::cmul(w, w1);
    }
    if (c < 3) wb = fft::cmul(wb, w8);
  }
  dft<32>(a);
}

// Z[nc - k] for k = lt + 32 j after pass_last (nc = 1024, j known at
// compile time), by one shuffle a component: for lt > 0 it sits in lane
// 32 - lt at register 31 - j, for lt = 0 in lane 0 at register (32 - j) & 31
// (Z[0] for j = 0).
__device__ __forceinline__ float2 split_partner(const float2 (&a)[32], int j, int lt) {
  const float2 s = lt ? a[31 - j] : a[(32 - j) & 31];
  const int src = (32 - lt) & 31;
  return make_float2(__shfl_sync(0xffffffffu, s.x, src), __shfl_sync(0xffffffffu, s.y, src));
}

// nc = 8 * 8 * (NC / 64) for NC <= 512: the last pass writes Z in natural
// order.  NC = 1024: 32 * 32, the last pass in registers (w1, w8 as in
// pass_last).  Ends with the warp in step (for NC = 1024: the buffers free).
template <int NC>
__device__ __forceinline__ void fft_regs(float2 (&a)[P1<NC>::P], float* re, float* im,
                                         const float2* __restrict__ tw, int lt,
                                         float2 w1 = float2{}, float2 w8 = float2{}) {
  if constexpr (NC == 1024) {
    pass<NC, 32, 1>(a, re, im, tw, lt);
    __syncwarp();
    gather<NC>(a, re, im, lt);
    __syncwarp();
    pass_last(a, w1, w8);
    return;
  } else {
    pass<NC, 8, 1>(a, re, im, tw, lt);
    __syncwarp();
    gather<NC>(a, re, im, lt);
    __syncwarp();
    pass<NC, 8, 8>(a, re, im, tw, lt);
    if constexpr (NC > 64) {
      __syncwarp();
      gather<NC>(a, re, im, lt);
      __syncwarp();
      pass<NC, NC / 64, 64>(a, re, im, tw, lt);
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------- cp.async ----
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// A tile's samples sit at slab + head: head is the misalignment of its first
// sample in floats, so a sample and its slot agree modulo 16 bytes.
__device__ __forceinline__ int tile_head(const float* x) { return (int)(((uintptr_t)x >> 2) & 3); }

// Start the copy of len samples from x (avail of them before the row's end)
// into slab + head; the rest are zeros.  Every thread of the block takes part.
__device__ __forceinline__ void stage_tile(float* slab, const float* x, int avail, int len) {
  const int head = tile_head(x);
  const int pre = min((4 - head) & 3, avail);
  const int n16 = (avail - pre) / 4;
  const int tail = pre + 4 * n16;
  float* s = slab + head;
  for (int i = threadIdx.x; i < pre; i += blockDim.x) cp_async4(s + i, x + i);
  for (int v = threadIdx.x; v < n16; v += blockDim.x) cp_async16(s + pre + 4 * v, x + pre + 4 * v);
  for (int i = tail + threadIdx.x; i < avail; i += blockDim.x) cp_async4(s + i, x + i);
  for (int i = avail + threadIdx.x; i < len; i += blockDim.x) s[i] = 0.f;
}

// -------------------------------------------------- persistent tile loop ----
// The grid walks n_tiles tiles persistently.  Tile t is row b = t /
// tiles_per_row, frames f0 = (t % tiles_per_row) * tile_f onward: the len
// samples from sig + b*T + f0*hop (zeros past the row's end) go by cp.async
// into one of two slabs of slab_floats at smem, the next tile's copy in
// flight while body(slab, b, f0) works on this one (slab points at the
// tile's first sample).  The only block barriers are the two per tile
// around the slab.  Every thread of the block calls it.
template <class Body>
__device__ __forceinline__ void tile_loop(float* smem, long long slab_floats, const float* sig,
                                          long long T, long long n_tiles, int tiles_per_row,
                                          int tile_f, int hop, int len, Body body) {
  auto tile_x = [&](long long t, long long& b, int& f0) {
    b = t / tiles_per_row;
    f0 = (int)(t - b * tiles_per_row) * tile_f;
    return sig + b * T + (long long)f0 * hop;
  };
  auto stage = [&](long long t, int buf) {
    long long b;
    int f0;
    const float* x = tile_x(t, b, f0);
    const long long left = T - (long long)f0 * hop;
    stage_tile(smem + buf * slab_floats, x, (int)(left < len ? left : len), len);
  };

  long long t = blockIdx.x;
  int cur = 0;
  if (t < n_tiles) stage(t, cur);
  cp_async_commit();
  for (; t < n_tiles; t += gridDim.x) {
    if (t + gridDim.x < n_tiles) stage(t + gridDim.x, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copy is done; the next may run on
    __syncthreads();
    long long b;
    int f0;
    const float* x = tile_x(t, b, f0);
    body(smem + cur * slab_floats + tile_head(x), b, f0);
    __syncthreads();  // every warp is done with this slab before it refills
    cur ^= 1;
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------ launch planning ----
constexpr int kMaxSmem = 232448;  // 227 KB, the per-block limit
constexpr int kMaxWarps = 8;      // warps of a persistent block, at most

// A launch shape: path, warps a block, dynamic shared bytes, resident
// blocks per SM and the grid.
struct Plan {
  int path, warps, blocks_per_sm;
  long long smem, grid;
};

// The most warps (of 8, 4, 2, 1) whose block's bytes(warps) fit in limit,
// else 0.
template <class Bytes>
int most_warps(Bytes bytes, long long limit) {
  for (int w = kMaxWarps; w >= 1; w /= 2)
    if (bytes(w) <= limit) return w;
  return 0;
}

// Resident blocks of kern per SM at warps * 32 threads and smem dynamic
// bytes, and the SMs of the current device.  The queries run once per
// (device, kernel, warps, smem), raising the kernel's dynamic shared-memory
// limit to kMaxSmem; later launches read the answer from a small cache.
template <class Kern>
cudaError_t residency(Kern kern, int warps, long long smem, int& blocks_per_sm, int& sms) {
  struct Entry {
    const void* fn;
    int dev, warps, blocks_per_sm, sms;
    long long smem;
  };
  constexpr int kEntries = 32;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int filled = 0, next = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kern);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled; ++i) {
    const Entry& c = cache[i];
    if (c.fn == fn && c.dev == dev && c.warps == warps && c.smem == smem) {
      blocks_per_sm = c.blocks_per_sm;
      sms = c.sms;
      return cudaSuccess;
    }
  }
  if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem)) !=
      cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kern, warps * 32, (size_t)smem);
  if (e != cudaSuccess) return e;
  if (blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  cache[next] = Entry{fn, dev, warps, blocks_per_sm, sms, smem};
  next = (next + 1) % kEntries;
  filled = filled < kEntries ? filled + 1 : kEntries;
  return cudaSuccess;
}

// p.blocks_per_sm and the persistent grid of kern for p.warps and p.smem:
// every block that is resident at once, at most n_tiles.
template <class Kern>
cudaError_t persistent_grid(Plan& p, Kern kern, long long n_tiles) {
  int sms = 0;
  const cudaError_t e = residency(kern, p.warps, p.smem, p.blocks_per_sm, sms);
  if (e != cudaSuccess) return e;
  const long long resident = (long long)p.blocks_per_sm * sms;
  p.grid = n_tiles < resident ? n_tiles : resident;
  return cudaSuccess;
}

}  // namespace fft
