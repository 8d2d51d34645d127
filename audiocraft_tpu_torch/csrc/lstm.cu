// One timestep of an LSTM layer's recurrence (kernel K2).
//
// Replaces audiocraft_tpu/ops/lstm_pallas.py:_lstm_kernel, which runs all T
// steps of a layer in one TPU program with W_hh^T resident in VMEM.  Here the
// wrapper launches this kernel once per timestep on the current stream:
//     gates = gx[t] + h[t-1] . W_hh^T      (gate order i, f, g, o)
//     c     = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h[t]  = sigmoid(o) * tanh(c)
// Gates and c are fp32; h is stored in the compute dtype (fp32 or bf16), and
// the next step reads it back from out[t-1], as the TPU kernel does.
//
// Bound on an H100: the step product is 2*B*H*4H operations (537 GFLOP per
// layer at T = 500, B = 128, H = 1024); W_hh (8 MB in bf16) stays in the 50 MB
// L2 across steps, so bytes are not the limit.  This first version sums in
// fp32 FMA outside the tensor cores, and at small batch the per-step launch is
// a large share.  The design keeps W_hh^T in no single SM: at H = 1024 it is
// larger than one SM's shared memory, which is why the TPU kernel's resident
// weight does not carry over.  A persistent cooperative kernel with W_hh^T
// split across SMs and a bf16 tensor-core step is later work.
//
// Each block owns kUnits hidden units j and kRows batch rows.  It computes
// the four pre-activations at columns j, H+j, 2H+j, 3H+j from one
// shared-memory tiled product over H, so one thread holds all four gates of
// its (row, unit) pairs and applies the cell update without an exchange.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 32;      // batch rows per block
constexpr int kUnits = 32;     // hidden units per block (x4 gate columns)
constexpr int kDepth = 32;     // reduction depth per shared-memory stage
constexpr int kThreads = 256;  // warp w owns rows w + 8 i; lane owns unit j0 + lane

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const T* __restrict__ gx_t, const T* __restrict__ w_hh,
                 const T* __restrict__ h_prev, T* __restrict__ h_out,
                 float* __restrict__ c, int batch, int hidden) {
  __shared__ float hs[kDepth][kRows + 1];
  __shared__ float ws[kDepth][4 * kUnits + 1];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;

  float acc[4][4];  // [row i][gate g]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;

  if (h_prev != nullptr) {  // h[-1] is zero: the product vanishes at t = 0
    for (int k0 = 0; k0 < hidden; k0 += kDepth) {
      for (int e = tid; e < kRows * kDepth; e += kThreads) {
        const int r = e / kDepth, kk = e % kDepth;
        const int b = b0 + r, kx = k0 + kk;
        hs[kk][r] = (b < batch && kx < hidden) ? to_f32(h_prev[(size_t)b * hidden + kx]) : 0.f;
      }
      for (int e = tid; e < 4 * kUnits * kDepth; e += kThreads) {
        const int col = e / kDepth, kk = e % kDepth;
        const int g = col / kUnits, u = j0 + col % kUnits, kx = k0 + kk;
        ws[kk][col] = (u < hidden && kx < hidden)
                          ? to_f32(w_hh[((size_t)g * hidden + u) * hidden + kx])
                          : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDepth; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = hs[kk][warp + 8 * i];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = ws[kk][g * kUnits + lane];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[i][g] = fmaf(a[i], w[g], acc[i][g]);
      }
      __syncthreads();
    }
  }

  const int j = j0 + lane;
  if (j >= hidden) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + warp + 8 * i;
    if (b >= batch) continue;
    const T* gx = gx_t + (size_t)b * 4 * hidden;
    const float ig = sigmoid(to_f32(gx[j]) + acc[i][0]);
    const float fg = sigmoid(to_f32(gx[hidden + j]) + acc[i][1]);
    const float gg = tanhf(to_f32(gx[2 * hidden + j]) + acc[i][2]);
    const float og = sigmoid(to_f32(gx[3 * hidden + j]) + acc[i][3]);
    const size_t at = (size_t)b * hidden + j;
    const float cn = fg * c[at] + ig * gg;
    c[at] = cn;
    store(h_out + at, og * tanhf(cn));
  }
}

template <typename T>
int launch(const void* gx, const void* w_hh, void* out, float* c, int t, int batch,
           int hidden, cudaStream_t stream) {
  const size_t step = (size_t)batch * hidden;
  const T* gx_t = static_cast<const T*>(gx) + (size_t)t * 4 * step;
  T* o = static_cast<T*>(out);
  const T* h_prev = t > 0 ? o + (size_t)(t - 1) * step : nullptr;
  const dim3 grid((hidden + kUnits - 1) / kUnits, (batch + kRows - 1) / kRows);
  lstm_step_kernel<T><<<grid, kThreads, 0, stream>>>(gx_t, static_cast<const T*>(w_hh),
                                                     h_prev, o + (size_t)t * step, c,
                                                     batch, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

// gx [T, B, 4H], w_hh [4H, H] and out [T, B, H] in one dtype (bf16 when
// is_bf16, else fp32); c [B, H] fp32, zero before step 0.  Computes out[t].
extern "C" int acx_lstm_step(const void* gx, const void* w_hh, void* out, float* c, int t,
                             int batch, int hidden, int is_bf16, void* stream) {
  if (t < 0 || batch <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(gx, w_hh, out, c, t, batch, hidden, s)
                 : launch<float>(gx, w_hh, out, c, t, batch, hidden, s);
}
