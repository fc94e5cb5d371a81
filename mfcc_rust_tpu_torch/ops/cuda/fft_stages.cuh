// Complex FFT stages in shared memory and the real-FFT split, shared by
// ct_mel.cu (K2) and speechpy_mfcc.cu (K1, its shared-memory path).
//
// stockham() runs Stockham's self-sorting Cooley-Tukey FFT of nc points:
// radix-4 stages, one radix-2 stage when log2 of the power-of-two part is
// odd, then one direct DFT stage for the odd part m_odd of nc (none when nc
// is a power of two), each stage reading one buffer and writing the other.
// tpf threads (lt = 0 .. tpf-1) share a transform; Sync is the barrier that
// holds them all (BlockSync when they span warps, WarpSync inside a warp).
// Ns is a power of two through the radix-4 and radix-2 stages, so indices are
// masks and shifts: no loop divides by a run-time size.  Stage reads
// in[j + q*nc/R] are consecutive over j; writes land at
// (j >> lg) << (lg + log2 R) + (j & (Ns - 1)) + r*Ns.
//
// Twiddles come from one n = 2 nc entry table tw[j] = (cos, sin)(2 pi j / n),
// standing for W_n^j = cos - i sin.

#pragma once

#include <cuda_runtime.h>

namespace fft {

// a * W with W = (cos, sin) standing for cos - i sin
__device__ __forceinline__ float2 cmulw(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, a.y * w.y), fmaf(a.y, w.x, -a.x * w.y));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct WarpSync {
  __device__ __forceinline__ void operator()() const { __syncwarp(); }
};

// nc = m_odd * 4^n4 * 2^has2 points from buf0; returns which buffer (0 or
// 1) holds the transform.  Every stage ends with sync().
template <class Sync>
__device__ __forceinline__ int stockham(float2* buf0, float2* buf1, const float2* __restrict__ tw,
                                        int nc, int n, int m_odd, int n4, int has2, int lt,
                                        int tpf, Sync sync) {
  auto bufs = [&](int s) { return s ? buf1 : buf0; };
  // W_{Ns R}^{k q} = W_n^{k q step} with step = 2 nc / (Ns R)
  int src = 0;
  int lg = 0;
  for (int s = 0; s < n4; ++s) {
    const int q4 = nc / 4;
    const int step = 2 * (nc / (4 << lg));
    const float2* in = bufs(src);
    float2* ob = bufs(src ^ 1);
    for (int j = lt; j < q4; j += tpf) {
      const int k = j & ((1 << lg) - 1);
      float2 a0 = in[j], a1 = in[j + q4], a2 = in[j + 2 * q4], a3 = in[j + 3 * q4];
      if (k) {
        const int t1 = k * step;
        a1 = cmulw(a1, __ldg(tw + t1));
        a2 = cmulw(a2, __ldg(tw + 2 * t1));
        a3 = cmulw(a3, __ldg(tw + 3 * t1));
      }
      const float2 s0 = cadd(a0, a2), d0 = csub(a0, a2);
      const float2 s1 = cadd(a1, a3), d1 = csub(a1, a3);
      float2* o = ob + ((j >> lg) << (lg + 2)) + k;
      o[0] = cadd(s0, s1);
      o[1 << lg] = make_float2(d0.x + d1.y, d0.y - d1.x);  // d0 - i d1
      o[2 << lg] = csub(s0, s1);
      o[3 << lg] = make_float2(d0.x - d1.y, d0.y + d1.x);  // d0 + i d1
    }
    src ^= 1;
    lg += 2;
    sync();
  }
  if (has2) {
    const int h = nc / 2;
    const int step = 2 * (nc / (2 << lg));
    const float2* in = bufs(src);
    float2* ob = bufs(src ^ 1);
    for (int j = lt; j < h; j += tpf) {
      const int k = j & ((1 << lg) - 1);
      const float2 a0 = in[j];
      const float2 a1 = k ? cmulw(in[j + h], __ldg(tw + k * step)) : in[j + h];
      float2* o = ob + ((j >> lg) << (lg + 1)) + k;
      o[0] = cadd(a0, a1);
      o[1 << lg] = csub(a0, a1);
    }
    src ^= 1;
    lg += 1;
    sync();
  }
  if (m_odd > 1) {
    // the odd part last, a direct DFT of p = m_odd points: Ns * p = nc, so
    // j < Ns and b_r = sum_q a_q W_nc^{j q} W_p^{q r} lands at j + r Ns
    const int p = m_odd;
    const int ns = 1 << lg;
    const float2* in = bufs(src);
    float2* ob = bufs(src ^ 1);
    for (int it = lt; it < nc; it += tpf) {
      const int j = it / p;
      const int r = it - j * p;
      float2 acc = make_float2(0.f, 0.f);
      for (int q = 0; q < p; ++q) {
        const long long e = 2LL * q * ((long long)j + (long long)r * ns);
        acc = cadd(acc, cmulw(in[j + q * ns], __ldg(tw + (int)(e % n))));
      }
      ob[j + r * ns] = acc;
    }
    src ^= 1;
    sync();
  }
  return src;
}

// Bin k <= nc of the real n-point FFT of x from Z, the nc-point FFT of
// z[t] = x[2t] + i x[2t+1]: E = (Z[k] + conj Z[nc-k])/2,
// O = -i (Z[k] - conj Z[nc-k])/2, X[k] = E + W_n^k O.  z(i) reads Z[i].
template <class ZAt>
__device__ __forceinline__ float2 real_split(ZAt z, int k, int nc, const float2* __restrict__ tw) {
  const float2 zk = z(k == nc ? 0 : k);
  const float2 zm = z(k == 0 ? 0 : nc - k);
  const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
  return cadd(e, cmulw(o, __ldg(tw + k)));
}

}  // namespace fft
