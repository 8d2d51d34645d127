// Data-movement probe (P1): the operations that
// scripts/probe_mosaic_ops.py:try_kernel and k_dotg try on the TPU, as small
// CUDA kernels on bf16.  There the question was which reshapes, strided
// slices and 3-D contractions the Mosaic compiler lowers; here each
// operation is a kernel that must build, launch and equal its plain torch
// result (apps/probe_ops.py prints OK or FAIL for each).
//
// - gather: y[r, c] = x[r * row_stride + c * col_stride] over the output's
//   [rows, cols].  A merge or split reshape of a contiguous array is the
//   gather with row_stride = cols, col_stride = 1 (the flat order is kept);
//   [:, ::k] and [::k, :] are the gathers with col_stride k or row_stride
//   k * width.  Memory-bound: each output element is read once and written
//   once, the threads of a warp on consecutive outputs.
// - contract: the merge [M * S, C] -> [M, S, C] and a dot_general over
//   (slot, channel) with taps [S, C, N]: y[m, n] = sum_{s, c} x[m S + s, c]
//   taps[s, c, n], products and sums in fp32, y rounded to bf16 once.  One
//   thread per output; at the probe's [128, 4, 64] x [4, 64, 32] it is 2 MFLOP.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int rows, int cols,
              long long row_stride, long long col_stride) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const long long r = i / cols, c = i - r * cols;
  y[i] = x[r * row_stride + c * col_stride];
}

__global__ void __launch_bounds__(kThreads)
contract_kernel(const bf16* __restrict__ x, const bf16* __restrict__ taps, bf16* __restrict__ y,
                int m_rows, int depth, int n_cols) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m_rows * n_cols) return;
  const int m = i / n_cols, n = i - m * n_cols;
  const bf16* xr = x + (size_t)m * depth;  // the S consecutive rows of width C, merged
  float acc = 0.f;
  for (int k = 0; k < depth; ++k)
    acc = fmaf(__bfloat162float(xr[k]), __bfloat162float(taps[(size_t)k * n_cols + n]), acc);
  y[i] = __float2bfloat16_rn(acc);
}

}  // namespace

// y [rows, cols] bf16 gathered from x at r * row_stride + c * col_stride.
extern "C" int acx_probe_gather(const void* x, void* y, int rows, int cols, long long row_stride,
                                long long col_stride, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * cols;
  gather_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), rows, cols, row_stride, col_stride);
  return (int)cudaGetLastError();
}

// y [m_rows, n_cols] = x [m_rows, depth] . taps [depth, n_cols], bf16 in and
// out, fp32 sums (depth = slots * channels of the merged input).
extern "C" int acx_probe_contract(const void* x, const void* taps, void* y, int m_rows, int depth,
                                  int n_cols, void* stream) {
  if (m_rows <= 0 || depth <= 0 || n_cols <= 0) return (int)cudaErrorInvalidValue;
  const int n = m_rows * n_cols;
  contract_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(taps), static_cast<bf16*>(y), m_rows,
      depth, n_cols);
  return (int)cudaGetLastError();
}
