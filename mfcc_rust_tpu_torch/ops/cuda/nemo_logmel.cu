// NeMo FastConformer's log-mel front end around K2 (api.log_mel_spectrogram_nemo):
// the prologue before K2 and the finish after it, for rows of the caller's
// batch that each hold their own number of samples (NeMo's
// AudioToMelSpectrogramPreprocessor → FilterbankFeatures.forward, eval, with
// normalize_batch's "per_feature"):
//
// 1. nemo_prologue_kernel: from the caller's (R, T) float32 audio and (R,)
//    int64 lengths to the (R, T + 2 half) buffer that K2 frames: NeMo's
//    preemphasis within each row's length, y[0] = x[0], y[t] = x[t] - cof
//    x[t - 1], zeros from the length on, and the centred STFT's zero pad of
//    half = n_fft / 2 samples on each side, in one pass.  Four outputs a
//    thread, float4 loads and stores where the rows allow; samples past a
//    row's length are written as zeros and never read.  Given used (R,)
//    int64, it also writes each row's frame count len // hop + 1 (0 where
//    len <= 0) there for K2 (ct_mel_ragged_kernel), and writes the row only
//    as far as those frames read, its first min(len, T) + 2 half samples:
//    the rest of the buffer is left unwritten, as K2 leaves the frames past
//    them, so neither does work in proportion to the padding.
// 2. nemo_finish_stats_kernel: each block takes one part of one row's
//    frames (K2's frame-major (R, F, M) power) below the row's frame count n
//    = min(len // hop + 1, F) (0 where len is 0), warps over frames and
//    lanes over mels (coalesced), and writes each mel's (mean, M2) of l =
//    ln(p + 2^-24) over the part.  Each thread keeps Welford's running mean
//    and sum of squared deviations over its frames; the block merges its
//    eight warps by Chan's rule.  Parts past n launch and leave at once.  The
//    block of part 0 writes the row's frame count.
// 3. nemo_finish_kernel: each block takes a strip of kTilesPerBlock tiles of
//    kTile frames x kTile mels of one row, merges the row's parts for its
//    mels by Chan's rule (each part's count follows from n and the part's
//    frames; the block's 8 warps each merge every 8th part, then warp 0
//    their 8 results), and writes (l - mean) / (sqrt(M2 / (n - 1)) + 1e-5)
//    below n and 0 from n on, mel-major (R, M, F), through shared-memory
//    tiles as the Whisper finish does.  Frames past n are written, never
//    read; a strip wholly past n writes its zeros straight, with no
//    statistics.
//
// Why Welford and Chan and not E[l^2] - mean^2: with |mean| up to ~17 (the
// guard's log) and deviations of a few tenths, the difference of squares
// loses ~10 of float32's 24 bits.  A running mean moves by (x - mean) / k,
// so the error of the mean and of M2 stays of the order of a few ulps of
// |l| times the square root of the frames each thread and each merge sees:
// at the cell's ~3,500 frames, ~1e-6 of |l| in the mean and ~1e-6 relative
// in the deviation, against the plain version's two passes.  A mel whose
// logs are all equal keeps its mean exact and M2 = 0, so its answer is 0,
// as in float64.
//
// Replaces no TPU kernel: the JAX package has no NeMo path.  A few
// operations a value and a log, so bytes bind both: the prologue reads each
// row's samples once and writes the padded buffer once; the finish reads
// the power of frames below n twice and writes the answer once.  Every step
// is float32 IEEE; the preemphasis rounds its product before the difference
// (no contraction), as the plain version does.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                      // a tile: kTile frames x kTile mels
constexpr int kPass = kThreads / kTile;        // tile rows a block moves at once
constexpr int kTilesPerBlock = 4;              // tiles of frames a finish block takes
constexpr int kMaxParts = 64;                  // parts a row's frames are split into
constexpr int kMaxRowsY = 65535;               // grid.y of a prologue launch
constexpr float kGuard = 5.9604644775390625e-08f;  // 2^-24
constexpr float kStdFloor = 1e-5f;

__device__ __forceinline__ float preemph(float x, float prev, float cof) {
  return __fsub_rn(x, __fmul_rn(cof, prev));
}

// the frames of row r that enter its statistics: min(len // hop + 1, F), 0
// where len <= 0; and the count NeMo returns, unclamped
__device__ __forceinline__ long long feature_count(long long len, int hop) {
  return len > 0 ? len / hop + 1 : 0;
}

// Chan's merge of (nb, mb, m2b) into (na, ma, m2a)
__device__ __forceinline__ void chan(float& na, float& ma, float& m2a, float nb, float mb,
                                     float m2b) {
  if (nb == 0.0f) return;
  const float n = na + nb;
  const float delta = mb - ma;
  ma += delta * (nb / n);
  m2a += m2b + delta * delta * (na * nb / n);
  na = n;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    nemo_prologue_kernel(const float* __restrict__ x, const long long* __restrict__ len,
                         float* __restrict__ out, long long* __restrict__ used, int t, int half,
                         int hop, float cof, long long row0) {
  const long long r = row0 + blockIdx.y;
  const long long j0 = 4LL * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
  const long long len_r = __ldg(len + r);
  const long long n = len_r < 0 ? 0 : (len_r > t ? t : len_r);
  const long long tp = t + 2LL * half;
  long long end = tp;  // the samples of the row written
  if (used) {
    if (j0 == 0) used[r] = feature_count(len_r, hop);
    end = n + 2LL * half;
  }
  if (j0 >= end) return;
  const float* src = x + r * t;
  const long long s0 = j0 - half;  // the sample of the first output
  float v[4];
  if (kVec4 && s0 >= 4 && s0 + 4 <= n) {  // s0 is a multiple of 4 here
    const float4 c = __ldg(reinterpret_cast<const float4*>(src + s0));
    const float p = __ldg(src + s0 - 1);
    v[0] = preemph(c.x, p, cof);
    v[1] = preemph(c.y, c.x, cof);
    v[2] = preemph(c.z, c.y, cof);
    v[3] = preemph(c.w, c.z, cof);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long s = s0 + k;
      v[k] = (s < 0 || s >= n) ? 0.0f
                               : (s == 0 ? __ldg(src) : preemph(__ldg(src + s), __ldg(src + s - 1), cof));
    }
  }
  float* dst = out + r * tp;
  if (kVec4) {  // tp is a multiple of 4
    *reinterpret_cast<float4*>(dst + j0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (j0 + k < tp) dst[j0 + k] = v[k];
  }
}

template <int kK>  // mels a lane takes: m <= 32 kK
__global__ void __launch_bounds__(kThreads)
    nemo_finish_stats_kernel(const float* __restrict__ p, const long long* __restrict__ len,
                             float2* __restrict__ part, long long* __restrict__ seq, int frames,
                             int m, int hop, int parts, int chunk) {
  __shared__ float s_mean[kWarps][32 * kK];
  __shared__ float s_m2[kWarps][32 * kK];
  __shared__ float s_cnt[kWarps];
  const long long r = blockIdx.x / parts;
  const int q = static_cast<int>(blockIdx.x - r * parts);
  const long long count = feature_count(__ldg(len + r), hop);
  if (q == 0 && threadIdx.x == 0) seq[r] = count;
  const int n = static_cast<int>(count < frames ? count : frames);
  const int lo = q * chunk;
  const int hi = lo + chunk < n ? lo + chunk : n;
  if (lo >= hi) return;  // the same for every thread of the block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* src = p + r * static_cast<long long>(frames) * m;
  float mean[kK], m2[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) mean[k] = m2[k] = 0.0f;
  float cnt = 0.0f;
  for (int f = lo + warp; f < hi; f += kWarps) {
    cnt += 1.0f;
    const float inv = 1.0f / cnt;
    const float* row = src + static_cast<long long>(f) * m;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int mm = lane + 32 * k;
      if (mm < m) {
        const float l = logf(__ldg(row + mm) + kGuard);
        const float d = l - mean[k];
        mean[k] += d * inv;
        m2[k] += d * (l - mean[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    s_mean[warp][lane + 32 * k] = mean[k];
    s_m2[warp][lane + 32 * k] = m2[k];
  }
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int mm = lane + 32 * k;
    if (mm >= m) continue;
    float na = s_cnt[0], ma = mean[k], m2a = m2[k];
    for (int w = 1; w < kWarps; ++w) chan(na, ma, m2a, s_cnt[w], s_mean[w][mm], s_m2[w][mm]);
    part[(r * parts + q) * m + mm] = make_float2(ma, m2a);
  }
}

__global__ void __launch_bounds__(kThreads)
    nemo_finish_kernel(const float* __restrict__ p, const long long* __restrict__ len,
                       const float2* __restrict__ part, float* __restrict__ out, int frames,
                       int m_count, int hop, int parts, int chunk, int strips_f, int tiles_m) {
  __shared__ float tile[kTile][kTile + 1];
  __shared__ float s_mean[kTile], s_scale[kTile];
  const long long per_row = static_cast<long long>(strips_f) * tiles_m;
  const long long r = blockIdx.x / per_row;
  const int t = static_cast<int>(blockIdx.x - r * per_row);
  const int m0 = (t % tiles_m) * kTile;  // neighbouring blocks: neighbouring mels of one strip
  const int f_start = (t / tiles_m) * kTilesPerBlock * kTile;
  const long long count = feature_count(__ldg(len + r), hop);
  const int n = static_cast<int>(count < frames ? count : frames);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float* dst = out + r * static_cast<long long>(m_count) * frames;
  if (f_start >= n) {  // the same for every thread of the block
    const int f_end = min(f_start + kTilesPerBlock * kTile, frames);
    for (int m = m0 + ty; m < m0 + kTile && m < m_count; m += kPass)
      for (int f = f_start + tx; f < f_end; f += kTile) dst[static_cast<long long>(m) * frames + f] = 0.0f;
    return;
  }
  {  // warp ty merges parts ty, ty + kPass, ...; warp 0 then the warps' results
    const int mm = m0 + tx;
    float na = 0.0f, ma = 0.0f, m2a = 0.0f;
    if (mm < m_count) {
      const int used = (n + chunk - 1) / chunk;
      for (int q = ty; q < used; q += kPass) {
        const int hi = (q + 1) * chunk < n ? (q + 1) * chunk : n;
        const float2 s = part[(r * parts + q) * m_count + mm];
        chan(na, ma, m2a, static_cast<float>(hi - q * chunk), s.x, s.y);
      }
    }
    tile[ty][tx] = na;
    tile[kPass + ty][tx] = ma;
    tile[2 * kPass + ty][tx] = m2a;
    __syncthreads();
    if (ty == 0) {
      for (int w = 1; w < kPass; ++w)
        chan(na, ma, m2a, tile[w][tx], tile[kPass + w][tx], tile[2 * kPass + w][tx]);
      // NeMo's deviation: unbiased, NaN (one frame) taken as 0, then the floor
      const float dev = n > 1 ? sqrtf(fmaxf(m2a, 0.0f) / static_cast<float>(n - 1)) : 0.0f;
      s_mean[tx] = ma;
      s_scale[tx] = dev + kStdFloor;
    }
    __syncthreads();  // the tiles below overwrite the warps' results
  }
  const float* src = p + r * static_cast<long long>(frames) * m_count;
  for (int s = 0; s < kTilesPerBlock; ++s) {
    const int f0 = f_start + s * kTile;
    if (f0 >= frames) break;  // the same for every thread of the block
#pragma unroll
    for (int j = 0; j < kTile / kPass; ++j) {
      const int f = f0 + ty + j * kPass, m = m0 + tx;
      if (f < frames && m < m_count) {
        float v = 0.0f;
        if (f < n) {
          const float l = logf(__ldg(src + static_cast<long long>(f) * m_count + m) + kGuard);
          v = (l - s_mean[tx]) / s_scale[tx];
        }
        tile[ty + j * kPass][tx] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTile / kPass; ++j) {
      const int m = m0 + ty + j * kPass, f = f0 + tx;
      if (m < m_count && f < frames) dst[static_cast<long long>(m) * frames + f] = tile[tx][ty + j * kPass];
    }
    __syncthreads();  // the next tile overwrites this one
  }
}

}  // namespace

extern "C" {

// x: rows x t contiguous float32 audio; len: rows int64 sample lengths;
// out: rows x (t + 2 half) float32; used: null (every sample of out
// written) or rows int64, each row's frame count at hop written there and
// out written only as far as those frames read.  vec4 needs t % 4 == 0, half % 4 == 0
// and 16-byte aligned x and out.  Launches the prologue on stream (one
// launch for up to 65,535 rows); returns a cudaError_t.
int nemo_prologue_launch(const float* x, const long long* len, float* out, long long* used,
                         long long rows, int t, int half, int hop, float cof, int vec4,
                         void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || t < 0 || half < 0 || hop < 1 || (vec4 && (t % 4 || half % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = (t + 2LL * half + 3) / 4;
  const long long blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (long long row0 = 0; row0 < rows; row0 += kMaxRowsY) {
    const long long ry = rows - row0 < kMaxRowsY ? rows - row0 : kMaxRowsY;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(ry));
    if (vec4)
      nemo_prologue_kernel<true><<<grid, kThreads, 0, s>>>(x, len, out, used, t, half, hop, cof,
                                                          row0);
    else
      nemo_prologue_kernel<false><<<grid, kThreads, 0, s>>>(x, len, out, used, t, half, hop, cof,
                                                           row0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// p: rows x frames x m contiguous float32 powers; len: rows int64 sample
// lengths; part: rows x parts x m float2 of scratch; seq: rows int64, the
// frame counts written; out: rows x m x frames float32.  Row r's frames are
// split into parts of chunk frames, (parts - 1) * chunk < frames <= parts *
// chunk, at most 64 parts; m <= 256.  Launches the two kernels on stream;
// returns a cudaError_t.
int nemo_finish_launch(const float* p, const long long* len, float* part, long long* seq,
                       float* out, long long rows, int frames, int m, int hop, int parts,
                       int chunk, void* stream) {
  if (rows == 0 || frames == 0) return 0;
  if (rows < 0 || frames < 0 || m < 1 || m > 256 || hop < 1 || parts < 1 ||
      parts > kMaxParts || chunk < 1 || static_cast<long long>(parts - 1) * chunk >= frames ||
      static_cast<long long>(parts) * chunk < frames)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_f = (frames + kTile - 1) / kTile;
  const int strips_f = (tiles_f + kTilesPerBlock - 1) / kTilesPerBlock;
  const int tiles_m = (m + kTile - 1) / kTile;
  const long long grid1 = rows * parts;
  const long long grid2 = rows * strips_f * tiles_m;
  if (grid1 > INT_MAX || grid2 > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* part2 = reinterpret_cast<float2*>(part);
  if (m <= 128)
    nemo_finish_stats_kernel<4><<<static_cast<unsigned>(grid1), kThreads, 0, s>>>(
        p, len, part2, seq, frames, m, hop, parts, chunk);
  else
    nemo_finish_stats_kernel<8><<<static_cast<unsigned>(grid1), kThreads, 0, s>>>(
        p, len, part2, seq, frames, m, hop, parts, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nemo_finish_kernel<<<static_cast<unsigned>(grid2), kThreads, 0, s>>>(
      p, len, part2, out, frames, m, hop, parts, chunk, strips_f, tiles_m);
  return static_cast<int>(cudaGetLastError());
}

const char* nemo_logmel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
