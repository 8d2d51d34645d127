// Residual-VQ encode, the argmin chain over n_q codebooks (kernel K1).
//
// Replaces audiocraft_tpu/ops/rvq_pallas.py:_rvq_kernel.  For each codebook q:
//     dist = -(|r|^2 - 2 r.E^T + |E|^2),  idx = first argmax(dist),  r <- r - E[idx]
// with the residual r carried from one codebook to the next.
//
// Bound on an H100: fp32 FMA.  The work is 2*N*D*K*n_q operations (134 GFLOP
// at N = 64000, D = 128, K = 2048, n_q = 4) against about 38 MB of traffic, so
// the card's fp32 rate outside the tensor cores is the limit.  TF32 tensor
// cores would be faster but round the distances differently from the
// reference, which changes tokens, so the kernel stays in fp32.
//
// Design: one block owns kRows residual rows and keeps them in shared memory
// for the whole chain, so the residual never goes back to device memory
// between codebooks (the point of the TPU kernel).  Codebook tiles of kCodes
// rows stream through shared memory in chunks of kChunk features.  Each
// (row, code) dot product is summed in fp32 over d = 0 .. D-1 in order, and
// the distance is formed in the reference's order of operations.  A running
// (best, index) per thread is updated with strict '>' over increasing code
// indices; the 16 threads that share a row then reduce with the lower index
// winning on equal values, which is the first-index tie-break of torch.argmax
// and jnp.argmax.  Ragged N and K are masked here, not padded by the caller.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;      // residual rows owned by one block
constexpr int kCodes = 64;     // codebook rows per streamed tile
constexpr int kChunk = 32;     // features per streamed chunk of a tile
constexpr int kMaxDim = 128;   // widest residual row a block holds
constexpr int kThreads = 256;  // thread (tr, tc): rows tr + 16 i, codes tc + 16 j

__global__ void __launch_bounds__(kThreads)
rvq_encode_kernel(const float* __restrict__ x, const float* __restrict__ embed,
                  const float* __restrict__ esq, int* __restrict__ codes,
                  int n, int d, int k, int n_q) {
  __shared__ float res[kRows][kMaxDim + 1];
  __shared__ float tile[kChunk][kCodes + 1];
  __shared__ float xsq[kRows];
  __shared__ int best_code[kRows];

  const int tid = threadIdx.x;
  const int tc = tid % 16;
  const int tr = tid / 16;
  const int row0 = blockIdx.x * kRows;

  for (int e = tid; e < kRows * d; e += kThreads) {
    const int r = e / d, c = e % d;
    res[r][c] = row0 + r < n ? x[(size_t)(row0 + r) * d + c] : 0.f;
  }

  for (int q = 0; q < n_q; ++q) {
    const float* eq = embed + (size_t)q * k * d;
    const float* esq_q = esq + (size_t)q * k;
    __syncthreads();  // residual of the previous codebook is complete
    if (tid < kRows) {
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = __fadd_rn(s, __fmul_rn(res[tid][c], res[tid][c]));
      xsq[tid] = s;
    }

    float best[4];
    int best_idx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[i] = -INFINITY;
      best_idx[i] = 0;
    }

    for (int k0 = 0; k0 < k; k0 += kCodes) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int d0 = 0; d0 < d; d0 += kChunk) {
        __syncthreads();  // the previous chunk has been read
        for (int e = tid; e < kChunk * kCodes; e += kThreads) {
          const int code = e / kChunk, c = e % kChunk;
          const int gk = k0 + code, gc = d0 + c;
          tile[c][code] = (gk < k && gc < d) ? eq[(size_t)gk * d + gc] : 0.f;
        }
        __syncthreads();
        const int width = min(kChunk, d - d0);
        for (int c = 0; c < width; ++c) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = res[tr + 16 * i][d0 + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = tile[c][tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int j = 0; j < 4; ++j) {  // increasing code index
        const int code = k0 + tc + 16 * j;
        if (code >= k) continue;
        const float e2 = esq_q[code];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float t = __fsub_rn(xsq[tr + 16 * i], __fmul_rn(2.f, acc[i][j]));
          const float dist = -__fadd_rn(t, e2);
          if (dist > best[i]) {
            best[i] = dist;
            best_idx[i] = code;
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = best[i];
      int idx = best_idx[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {  // stays inside the 16 lanes of a row
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (ov > v || (ov == v && oi < idx)) {
          v = ov;
          idx = oi;
        }
      }
      if (tc == 0) best_code[tr + 16 * i] = idx;
    }
    __syncthreads();

    for (int r = tid; r < kRows; r += kThreads)
      if (row0 + r < n) codes[(size_t)q * n + row0 + r] = best_code[r];
    for (int e = tid; e < kRows * d; e += kThreads) {
      const int r = e / d, c = e % d;
      res[r][c] = __fsub_rn(res[r][c], eq[(size_t)best_code[r] * d + c]);
    }
  }
}

}  // namespace

extern "C" int acx_rvq_max_dim() { return kMaxDim; }

// x [n, d], embed [n_q, k, d], esq [n_q, k] fp32; codes [n_q, n] int32.
extern "C" int acx_rvq_encode(const float* x, const float* embed, const float* esq,
                              int* codes, int n, int d, int k, int n_q, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxDim || k <= 0 || n_q <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kRows - 1) / kRows);
  rvq_encode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, embed, esq, codes,
                                                                 n, d, k, n_q);
  return (int)cudaGetLastError();
}

extern "C" const char* acx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
