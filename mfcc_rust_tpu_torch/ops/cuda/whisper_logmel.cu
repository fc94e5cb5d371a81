// Whisper's log-mel finish of K2's mel power (api.log_mel_spectrogram_whisper):
// from K2's frame-major (R, F, M) float32 power of each row's F centred
// frames to Whisper's (R, M, F - 1) answer, mel-major, the last frame dropped
// (openai/whisper audio.py, log_mel_spectrogram):
//
//   L = log10(max(p, 1e-10)),  L = max(L, max_row L - 8),  out = (L + 4) / 4,
//
// the maximum taken over each row's own F - 1 kept frames (the batched rule
// of transformers' WhisperFeatureExtractor).
//
// Replaces no TPU kernel: the JAX package has no Whisper path.  In plain
// PyTorch the finish is 4-5 passes over K2's output (features.whisper_finish).
// A handful of operations a value, so bytes bind it on this card.  The row's
// maximum must be known before any value of the row is written, so the
// power is read twice and the answer written once, in two kernels launched
// back to back on the caller's stream:
//
// 1. whisper_logmel_rowmax_kernel: each block takes one part of one row's
//    kept values (frames 0 .. F - 2 lie contiguous) and writes their largest
//    power to part[row][q]; float4 loads where the rows allow.  Rows are taken
//    last first, so that the first reads find the end of K2's output, which
//    K2 wrote last, still in the L2.
// 2. whisper_logmel_kernel: each block takes a strip of kTilesPerBlock tiles
//    of kTile frames x kTile mels of one row, rows first first, so that its
//    first reads find the rows that kernel 1 read last.  It first reduces its
//    row's parts to the floor, log10(max(max p, 1e-10)) - 8: log10 is
//    monotone, so that is the largest L less 8 without a log of every value.
//    Each tile is read along the mels (coalesced), turned into the answer,
//    and written along the frames through shared memory.
//
// A NaN power stays NaN, and a NaN maximum makes its row NaN, as the plain
// version's clamp, amax and maximum give.  Every step is float32 IEEE.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;                      // a tile: kTile frames x kTile mels
constexpr int kPass = kThreads / kTile;        // tile rows a block moves at once
constexpr int kTilesPerBlock = 4;              // tiles of frames a finish block takes
constexpr int kMaxParts = 128;                 // parts a row's maximum is split into
constexpr float kAmin = 1e-10f;

// max(a, b) in which a NaN wins and stays
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    whisper_logmel_rowmax_kernel(const float* __restrict__ p, float* __restrict__ part,
                                 long long rows, long long row_floats, long long kept_floats,
                                 long long chunk, int parts) {
  const long long b = blockIdx.x;
  const long long r = rows - 1 - b / parts;  // the last row first
  const int q = static_cast<int>(b % parts);
  const float* src = p + r * row_floats;
  const long long lo = q * chunk;
  const long long hi = lo + chunk < kept_floats ? lo + chunk : kept_floats;
  float m = 0.0f;  // a power is never below 0
  if (kVec4) {     // lo, hi and the row's start are multiples of 4 floats
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (long long i = lo / 4 + threadIdx.x; i < hi / 4; i += kThreads) {
      const float4 v = __ldg(s4 + i);
      m = nan_max(nan_max(m, v.x), nan_max(v.y, nan_max(v.z, v.w)));
    }
  } else {
#pragma unroll 4
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) m = nan_max(m, __ldg(src + i));
  }
  m = warp_max(m);
  __shared__ float wmax[kThreads / 32];
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = wmax[0];
    for (int w = 1; w < kThreads / 32; ++w) t = nan_max(t, wmax[w]);
    part[r * parts + q] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
    whisper_logmel_kernel(const float* __restrict__ p, const float* __restrict__ part,
                          float* __restrict__ out, int frames, int m_count, int parts,
                          int strips_f, int tiles_m) {
  __shared__ float tile[kTile][kTile + 1];
  __shared__ float row_floor;
  const long long per_row = static_cast<long long>(strips_f) * tiles_m;
  const long long r = blockIdx.x / per_row;
  const int t = static_cast<int>(blockIdx.x - r * per_row);
  const int m0 = (t % tiles_m) * kTile;  // neighbouring blocks: neighbouring mels of one strip
  const int f_start = (t / tiles_m) * kTilesPerBlock * kTile;
  const int kept = frames - 1;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  if (ty == 0) {
    float mx = 0.0f;
    for (int q = tx; q < parts; q += 32) mx = nan_max(mx, __ldg(part + r * parts + q));
    mx = warp_max(mx);
    if (tx == 0) row_floor = log10f(mx < kAmin ? kAmin : mx) - 8.0f;
  }
  __syncthreads();
  const float fl = row_floor;
  const float* src = p + r * static_cast<long long>(frames) * m_count;
  float* dst = out + r * static_cast<long long>(m_count) * kept;
  for (int s = 0; s < kTilesPerBlock; ++s) {
    const int f0 = f_start + s * kTile;
    if (f0 >= kept) break;  // the same for every thread of the block
#pragma unroll
    for (int j = 0; j < kTile / kPass; ++j) {
      const int f = f0 + ty + j * kPass, m = m0 + tx;
      if (f < kept && m < m_count) {
        const float v = __ldg(src + static_cast<long long>(f) * m_count + m);
        const float l = log10f(v < kAmin ? kAmin : v);  // a NaN stays NaN
        tile[ty + j * kPass][tx] = (((l < fl || fl != fl) ? fl : l) + 4.0f) * 0.25f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTile / kPass; ++j) {
      const int m = m0 + ty + j * kPass, f = f0 + tx;
      if (m < m_count && f < kept) dst[static_cast<long long>(m) * kept + f] = tile[tx][ty + j * kPass];
    }
    __syncthreads();  // the next tile overwrites this one
  }
}

}  // namespace

extern "C" {

// p: rows x frames x m contiguous float32 powers (16-byte aligned rows when
// vec4, which needs m % 4 == 0 and chunk % 4 == 0); part: rows x parts
// floats of scratch; out: rows x m x (frames - 1) float32.  Row r's kept
// values are split into parts of chunk floats, (parts - 1) * chunk < (frames
// - 1) * m <= parts * chunk, at most 128 parts.  Launches the two kernels on
// stream; returns a cudaError_t.
int whisper_logmel_launch(const float* p, float* part, float* out, long long rows, int frames,
                          int m, int parts, long long chunk, int vec4, void* stream) {
  if (rows == 0 || frames < 2) return 0;
  const long long kept_floats = static_cast<long long>(frames - 1) * m;
  if (rows < 0 || m < 1 || parts < 1 || parts > kMaxParts || chunk < 1 ||
      (parts - 1) * chunk >= kept_floats || parts * chunk < kept_floats ||
      (vec4 && (m % 4 || chunk % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_f = (frames - 1 + kTile - 1) / kTile;
  const int strips_f = (tiles_f + kTilesPerBlock - 1) / kTilesPerBlock;
  const int tiles_m = (m + kTile - 1) / kTile;
  const long long grid1 = rows * parts;
  const long long grid2 = rows * strips_f * tiles_m;
  if (grid1 > INT_MAX || grid2 > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_floats = static_cast<long long>(frames) * m;
  if (vec4)
    whisper_logmel_rowmax_kernel<true><<<static_cast<unsigned>(grid1), kThreads, 0, s>>>(
        p, part, rows, row_floats, kept_floats, chunk, parts);
  else
    whisper_logmel_rowmax_kernel<false><<<static_cast<unsigned>(grid1), kThreads, 0, s>>>(
        p, part, rows, row_floats, kept_floats, chunk, parts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  whisper_logmel_kernel<<<static_cast<unsigned>(grid2), kThreads, 0, s>>>(
      p, part, out, frames, m, parts, strips_f, tiles_m);
  return static_cast<int>(cudaGetLastError());
}

const char* whisper_logmel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
