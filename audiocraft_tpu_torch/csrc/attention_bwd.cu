// Full-sequence self-attention backward (kernel K3b): two kernels, dK/dV and dQ.
//
// Replaces the custom VJP of the bundled Pallas flash attention that
// audiocraft_tpu/ops/attention_pallas.py:fused_attention differentiates on
// the TPU: _flash_attention_bwd_dkv and _flash_attention_bwd_dq of
// jax/experimental/pallas/ops/tpu/flash_attention.py, one pallas_call each.
// For q, k, v, dO in [B, T, H, D] (the JAX package's layout, read by
// strides), the forward's fp32 lse = m + log(l) and di = rowsum(dO * O), both
// [B, H, T] fp32, every tile recomputes
//     s  = round(q * scale) . k^T      (fp32, q * scale rounded to the input
//                                       dtype, as the forward kernel does)
//     P  = exp(s - lse)
//     dV = P^T dO                       dP = dO V^T
//     dS = P * (dP - di)
//     dQ = scale * dS K                 dK = dS^T round(q * scale)
// so the [T, T] probabilities never reach device memory.  dK uses the same
// rounded q * scale as s: that is the derivative of what the forward and the
// plain version compute, and equals scale * dS^T q up to that rounding.
// Keys at index >= T and, when causal, keys after the query are masked (P is
// 0 there); nothing is padded.  Tiles wholly above the diagonal are skipped,
// as the Pallas kernel's below_or_on_diag does.  Gradients are written in the
// input dtype, fp32 or bf16; all arithmetic is fp32.
//
// Bound on an H100: five products of 2*B*H*T^2*D operations, halved when
// causal (46 GFLOP at the training shape B = 4, H = 16, T = 1501, D = 64),
// against about 87 MB of q, k, v, dO, dq, dk, dv in bf16, so the operations
// set the bound (0.047 ms at the bf16 tensor-core rate).
//
// Design (a simple kernel that is right first): the two kernels share no
// state, and neither uses atomics, so the result is deterministic.
// - dK/dV: a block owns one 64-key tile of one (batch, head), keeps K and V
//   in shared memory and its dK, dV sums in registers, and loops over 64-row
//   query tiles (from the diagonal on when causal), as the Pallas kernel's
//   grid walks its query blocks for one key block.
// - dQ: a block owns one 64-row query tile, keeps q * scale, dO, lse and di
//   and its dQ sum, and loops over key tiles (up to the diagonal when causal).
// Both run fp32 FMA outside the tensor cores for either dtype (bf16 values
// widen to fp32 in shared memory), so the ceiling is the fp32 rate: 7 products
// instead of 5 (s and dP are computed in both kernels), 0.96 ms at the shape
// above.  256 threads: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 of its
// tile, columns tx + 16 j of the streamed tile and features tx + 16 c;
// P and dS go through shared memory into the products over the streamed
// rows.  mma.sync or wgmma, TMA and a pipelined ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;      // rows of every query and key tile
constexpr int kMaxDim = 128;   // widest head a block holds
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLP = kRows + 1; // padded row of a P or dS tile

struct Strides {  // element strides of a [B, T, H, D] view; D is contiguous
  long long b, t, h;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rounded(float x, const float*) { return x; }
__device__ __forceinline__ float rounded(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;  // [B, H, T]
  void *dq, *dk, *dv;     // contiguous [B, T, H, D]
  int batch, seq, heads, dim;
  Strides qs, ks, vs, dos;
  float scale;
  int causal;
  cudaStream_t stream;
};

// Rows r0 .. r0 + 63 of x (one batch and head) into tile[r][d], fp32, rows
// and features past the end as zeros; scaled by `scale` and rounded to T.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* tile, const T* x, Strides st, int r0, int seq,
                                          int dim, float scale) {
  constexpr int LD = DP + 1;
  for (int e = threadIdx.x; e < kRows * DP; e += kThreads) {
    const int r = e / DP, d = e % DP, t = r0 + r;
    float val = 0.f;
    if (t < seq && d < dim) {
      val = widen(x[t * st.t + d]);
      if (scale != 1.f) val = rounded(val * scale, x);
    }
    tile[r * LD + d] = val;
  }
}

template <int DP>
constexpr size_t smem_dkv() {  // K, V, q * scale, dO tiles; P^T and dS^T; lse, di
  return sizeof(float) * (4 * kRows * (DP + 1) + 2 * kRows * kLP + 2 * kRows);
}

template <int DP>
constexpr size_t smem_dq() {   // q * scale, dO, K, V tiles; dS
  return sizeof(float) * (4 * kRows * (DP + 1) + kRows * kLP);
}

// s and dP of a 4 x 4 patch: rows of a and b (4 ty + i) against rows of c and
// e (tx + 16 j), over DP features.
template <int DP>
__device__ __forceinline__ void two_products(const float* a, const float* c, const float* b,
                                             const float* e, int ty, int tx, float (&s)[4][4],
                                             float (&p)[4][4]) {
  constexpr int LD = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = p[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float ra[4], rb[4], rc[4], re[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ra[i] = a[(4 * ty + i) * LD + d];
      rb[i] = b[(4 * ty + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rc[j] = c[(tx + 16 * j) * LD + d];
      re[j] = e[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(ra[i], rc[j], s[i][j]);
        p[i][j] = fmaf(rb[i], re[j], p[i][j]);
      }
  }
}

// ---------------------------------------------------------------- dK, dV

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                     Strides qs_, Strides ks_, Strides vs_, Strides dos_, int seq, int heads,
                     int dim, float scale, int causal) {
  constexpr int LD = DP + 1;
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* ks = smem;                 // [kRows][LD]  this block's keys
  float* vs = ks + kRows * LD;      // [kRows][LD]  and values
  float* qs = vs + kRows * LD;      // [kRows][LD]  streamed q * scale
  float* dos = qs + kRows * LD;     // [kRows][LD]  streamed dO
  float* pt = dos + kRows * LD;     // [kRows][kLP] P^T: [key][query]
  float* dst = pt + kRows * kLP;    // [kRows][kLP] dS^T
  float* lse_s = dst + kRows * kLP; // [kRows]
  float* di_s = lse_s + kRows;      // [kRows]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* dob = dout + b * dos_.b + h * dos_.h;
  const float* lse_b = lse + ((size_t)b * heads + h) * seq;
  const float* di_b = di + ((size_t)b * heads + h) * seq;

  load_tile<T, DP>(ks, k + b * ks_.b + h * ks_.h, ks_, k0, seq, dim, 1.f);
  load_tile<T, DP>(vs, v + b * vs_.b + h * vs_.h, vs_, k0, seq, dim, 1.f);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: query tiles that end before this key tile sees nothing of it
  for (int q0 = causal ? k0 : 0; q0 < seq; q0 += kRows) {
    __syncthreads();  // the previous tile's products are done with qs, dos, pt, dst
    load_tile<T, DP>(qs, qb, qs_, q0, seq, dim, scale);
    load_tile<T, DP>(dos, dob, dos_, q0, seq, dim, 1.f);
    if (tid < kRows) {
      const int t = q0 + tid;
      lse_s[tid] = t < seq ? lse_b[t] : 0.f;
      di_s[tid] = t < seq ? di_b[t] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // [key 4 ty + i][query tx + 16 j]
    two_products<DP>(ks, qs, vs, dos, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * ty + i, r = tx + 16 * j, query = q0 + r;
        const bool in = key < seq && query < seq && !(causal && key > query);
        const float p = in ? expf(s[i][j] - lse_s[r]) : 0.f;
        pt[(4 * ty + i) * kLP + r] = p;
        dst[(4 * ty + i) * kLP + r] = p * (dp[i][j] - di_s[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float p[4], ds[4], o[NC], x[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = pt[(4 * ty + i) * kLP + r];
        ds[i] = dst[(4 * ty + i) * kLP + r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        o[c] = dos[r * LD + tx + 16 * c];
        x[c] = qs[r * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[i][c] = fmaf(p[i], o[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds[i], x[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= seq) continue;
    const size_t row = (((size_t)b * seq + key) * heads + h) * dim;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dim) {
        put(dk + row + d, dk_acc[i][c]);
        put(dv + row + d, dv_acc[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------- dQ

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, Strides qs_, Strides ks_,
                    Strides vs_, Strides dos_, int seq, int heads, int dim, float scale,
                    int causal) {
  constexpr int LD = DP + 1;
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [kRows][LD]  this block's q * scale
  float* dos = qs + kRows * LD;  // [kRows][LD]  and dO
  float* ks = dos + kRows * LD;  // [kRows][LD]  streamed keys
  float* vs = ks + kRows * LD;   // [kRows][LD]  and values
  float* dss = vs + kRows * LD;  // [kRows][kLP] dS: [query][key]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;
  const float* lse_b = lse + ((size_t)b * heads + h) * seq;
  const float* di_b = di + ((size_t)b * heads + h) * seq;

  load_tile<T, DP>(qs, q + b * qs_.b + h * qs_.h, qs_, q0, seq, dim, scale);
  load_tile<T, DP>(dos, dout + b * dos_.b + h * dos_.h, dos_, q0, seq, dim, 1.f);
  float row_lse[4], row_di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    row_lse[i] = t < seq ? lse_b[t] : 0.f;
    row_di[i] = t < seq ? di_b[t] : 0.f;
  }

  float dq_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;

  // causal: key tiles that start after this query tile's last row are skipped
  const int k_end = causal ? min(seq, q0 + kRows) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kRows) {
    __syncthreads();  // the previous tile's product is done with ks and dss
    load_tile<T, DP>(ks, kb, ks_, k0, seq, dim, 1.f);
    load_tile<T, DP>(vs, vb, vs_, k0, seq, dim, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];  // [query 4 ty + i][key tx + 16 j]
    two_products<DP>(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int query = q0 + 4 * ty + i, c = tx + 16 * j, key = k0 + c;
        const bool in = key < seq && query < seq && !(causal && key > query);
        const float p = in ? expf(s[i][j] - row_lse[i]) : 0.f;
        dss[(4 * ty + i) * kLP + c] = p * (dp[i][j] - row_di[i]);
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kRows; ++c) {
      float ds[4], x[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(4 * ty + i) * kLP + c];
#pragma unroll
      for (int f = 0; f < NC; ++f) x[f] = ks[c * LD + tx + 16 * f];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int f = 0; f < NC; ++f) dq_acc[i][f] = fmaf(ds[i], x[f], dq_acc[i][f]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= seq) continue;
    const size_t row = (((size_t)b * seq + t) * heads + h) * dim;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dim) put(dq + row + d, scale * dq_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename T, int DP>
int launch_dkv(const Args& a) {
  auto kernel = flash_bwd_dkv_kernel<T, DP>;
  const size_t smem = smem_dkv<DP>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.seq + kRows - 1) / kRows, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.qs, a.ks, a.vs, a.dos, a.seq, a.heads, a.dim, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<T, DP>;
  const size_t smem = smem_dq<DP>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.seq + kRows - 1) / kRows, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(a.dq), a.qs, a.ks, a.vs,
      a.dos, a.seq, a.heads, a.dim, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, bool dkv) {
  if (a.dim <= 32) return dkv ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
  if (a.dim <= 64) return dkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
  return dkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
}

int run(const Args& a, int is_bf16, bool dkv) {
  if (a.batch <= 0 || a.seq <= 0 || a.heads <= 0 || a.dim <= 0 || a.dim > kMaxDim ||
      a.heads > 65535 || a.batch > 65535)
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? dispatch<bf16>(a, dkv) : dispatch<float>(a, dkv);
}

}  // namespace

// q, k, v, dout: [B, T, H, D] views with contiguous D and the given element
// strides (batch, time, head), one dtype (bf16 when is_bf16, else fp32);
// lse, di: contiguous fp32 [B, H, T]; dk, dv: contiguous [B, T, H, D] in the
// input dtype.
extern "C" int acx_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const float* lse, const float* di,
                                     void* dk, void* dv, int batch, int seq, int heads, int dim,
                                     long long q_sb, long long q_st, long long q_sh,
                                     long long k_sb, long long k_st, long long k_sh,
                                     long long v_sb, long long v_st, long long v_sh,
                                     long long do_sb, long long do_st, long long do_sh,
                                     float scale, int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, lse, di, nullptr, dk, dv, batch, seq, heads, dim,
               {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
               {do_sb, do_st, do_sh}, scale, causal, (cudaStream_t)stream};
  return run(a, is_bf16, true);
}

// The same inputs; dq: contiguous [B, T, H, D] in the input dtype.
extern "C" int acx_attention_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* di,
                                    void* dq, int batch, int seq, int heads, int dim,
                                    long long q_sb, long long q_st, long long q_sh,
                                    long long k_sb, long long k_st, long long k_sh,
                                    long long v_sb, long long v_st, long long v_sh,
                                    long long do_sb, long long do_st, long long do_sh,
                                    float scale, int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, lse, di, dq, nullptr, nullptr, batch, seq, heads, dim,
               {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
               {do_sb, do_st, do_sh}, scale, causal, (cudaStream_t)stream};
  return run(a, is_bf16, false);
}
