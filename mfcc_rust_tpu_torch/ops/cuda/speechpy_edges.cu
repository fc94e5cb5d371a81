// X_0 and X_{N/2} of every speechpy frame, summed in float64, written into
// the chunk-GEMM product (features._exact_edges).
//
// The product y = frames @ [C_trim | S_trim | w | +-w] sums in float32.  X_0
// (column 0 and the window column) is real and cancels, and the first
// speechpy filter weighs the DC bin alone, so on the rare frame where it
// nearly vanishes the product's rounding reaches that band's log.  This
// kernel reads each frame once more and writes X_0 = sum w_t x_t into the
// columns col_dc and col_w, and X_{N/2} = sum (-1)^t w_t x_t into col_alt,
// each summed in float64 and rounded once to float32.
//
// One warp a frame: lane l sums samples l, l + 32, ... of the frame, kUnroll
// loads issued before their sums, then a shuffle reduction.  Samples at or
// past the row's valid length t read as zero, as the product's zero pad.
// Neighbouring frames overlap by fl - hop samples, which the L2 serves.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

__global__ void edge_sums_kernel(const float* __restrict__ x, long long x_row, long long t,
                                 const double* __restrict__ w, int fl, int hop,
                                 long long rows, int frames, float* __restrict__ y,
                                 long long y_row, int y_frame, int col_dc, int col_w,
                                 int col_alt) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * frames) return;  // whole warps only: the warp index is uniform
  const long long b = warp / frames;
  const int f = static_cast<int>(warp % frames);
  const long long start = static_cast<long long>(f) * hop;
  const float* xf = x + b * x_row + start;
  double s0 = 0.0, s1 = 0.0;
  for (int base = 0; base < fl; base += 32 * kUnroll) {
    float v[kUnroll];  // kUnroll loads in flight a lane before the sums use them
    double wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * 32 + lane;
      const bool in = i < fl && start + i < t;
      v[u] = in ? xf[i] : 0.0f;
      wv[u] = in ? w[i] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const double d = static_cast<double>(v[u]) * wv[u];
      s0 += d;
      s1 += ((base + u * 32 + lane) & 1) ? -d : d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_down_sync(0xffffffffu, s0, o);
    s1 += __shfl_down_sync(0xffffffffu, s1, o);
  }
  if (lane == 0) {
    float* yf = y + b * y_row + static_cast<long long>(f) * y_frame;
    const float x0 = static_cast<float>(s0);
    yf[col_dc] = x0;
    yf[col_w] = x0;
    yf[col_alt] = static_cast<float>(s1);
  }
}

}  // namespace

extern "C" {

// x: rows of t valid samples, row stride x_row (floats); w: fl float64
// window weights; y: rows x frames x (at least col_alt + 1) floats, row
// stride y_row, frame stride y_frame.  Returns a cudaError_t.
int edge_sums_launch(const float* x, long long x_row, long long t, const double* w, int fl,
                     int hop, long long rows, int frames, float* y, long long y_row,
                     int y_frame, int col_dc, int col_w, int col_alt, void* stream) {
  const long long warps = rows * frames;
  if (warps == 0) return 0;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  edge_sums_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, x_row, t, w, fl, hop, rows, frames,
                                                          y, y_row, y_frame, col_dc, col_w,
                                                          col_alt);
  return static_cast<int>(cudaGetLastError());
}

const char* edge_sums_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
