// Full-sequence self-attention forward with an online softmax (kernel K3f).
//
// Replaces the bundled Pallas flash_attention forward that
// audiocraft_tpu/ops/attention_pallas.py:fused_attention calls on the TPU.
// For q, k, v in [B, T, H, D] (the JAX package's layout, read by strides):
//     o[b, t, h] = sum_s softmax_s((q[b, t, h] * scale) . k[b, s, h]) v[b, s, h]
// over keys s < T (and s <= t when causal).  Scores, the running max, the
// running sum and the output accumulator are fp32; the [T, T] scores never
// reach device memory.
//
// Bound on an H100: 4*B*H*T^2*D operations (73.7 GFLOP at B = 8, H = 16,
// T = 1500, D = 64) against about 98 MB of q, k, v and o in bf16, so the
// operations set the bound (0.075 ms at the bf16 tensor-core rate).
//
// Two kernels, one per input dtype, with the same blocking: a block owns 64
// query rows of one (batch, head) and streams 64-key tiles of K and V through
// shared memory.  What the TPU wrapper padded (T to a multiple of 128, D from
// 64 to 128) is masked here instead: keys at index >= T, and keys after the
// query when causal, score -inf inside the tile loop; features >= D load as
// zeros.  A row whose keys so far are all masked keeps max -inf; its
// exponentials are taken against 0 instead, so no inf - inf turns into NaN.
// q * scale is rounded to the input dtype before the products, as the plain
// version computes it.  When asked, the kernel also writes each row's fp32
// log-sum-exp, lse[b, h, t] = m + log(l) of the scores it normalised (the
// JAX forward saves l and m, which carry the same), for the backward kernels
// in attention_bwd.cu to recompute P = exp(s - lse).
//
// - bf16 (the serving path): tensor cores through mma.sync m16n8k16, fp32
//   accumulation.  Each of 4 warps owns 16 query rows, keeps their q
//   fragments in registers, computes a 16 x 64 score tile, does the online
//   softmax on the accumulator fragment (row max and sum over the 4 threads
//   of a row by shuffles), and feeds the probabilities back as the A operand
//   of P.V without leaving registers.  P is split into a bf16 high part and
//   a bf16 remainder, two products with the same V fragments, so P keeps
//   about 16 bits, as the plain version's fp32 P does in effect: one bf16 P
//   alone would add a relative error of 2^-9, a whole bf16 step of the
//   output, which at outputs of magnitude 2 or more nears the 2e-2 check.
//   Products of bf16 values are exact in the fp32 accumulator.  wgmma, TMA
//   and a pipelined ring are later work.
// - fp32 (the parity path): fp32 FMA outside the tensor cores, so its ceiling
//   is the fp32 rate (1.1 ms at the shape above).  256 threads: thread
//   (ty, tx) owns query rows 4 ty .. 4 ty + 3, key columns tx + 16 j of a
//   tile and output features tx + 16 c; probabilities go through shared
//   memory into P.V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRowsQ = 64;   // query rows per block
constexpr int kRowsK = 64;   // key and value rows per streamed tile
constexpr int kMaxDim = 128; // widest head a block holds

struct Strides {  // element strides of a [B, T, H, D] view; D is contiguous
  long long b, t, h;
};

// ---------------------------------------------------------------- bf16, mma

constexpr int kWarpsBf16 = kRowsQ / 16;
constexpr int kThreadsBf16 = 32 * kWarpsBf16;

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// (x, y) as a bf16 pair hi and the bf16 pair of what hi leaves out, lo
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const bf16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  hi = pack(hx, hy);
  lo = pack(x - __bfloat162float(hx), y - __bfloat162float(hy));
}

// d += a . b for a 16x16 bf16 A (row), a 16x8 bf16 B (col), fp32 16x8 D
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DP>
__global__ void __launch_bounds__(kThreadsBf16)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, Strides qs_,
                      Strides ks_, Strides vs_, int seq, int heads, int dim, float scale,
                      int causal) {
  constexpr int LD = DP + 8;     // padded rows: fragment reads hit distinct banks
  constexpr int KSTEPS = DP / 16;
  constexpr int NT_O = DP / 8;   // 8-feature tiles of the output
  constexpr int NT_S = kRowsK / 8;
  __shared__ __align__(16) bf16 ks[kRowsK][LD];
  __shared__ __align__(16) bf16 vs[kRowsK][LD];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;    // fragment row (and row + 8)
  const int tig = lane % 4;  // fragment column pair
  const int q0 = blockIdx.x * kRowsQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows[2] = {q0 + (tid / 32) * 16 + g, q0 + (tid / 32) * 16 + g + 8};

  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;

  auto q_at = [&](int t, int d) -> float {
    if (t >= seq || d >= dim) return 0.f;
    return __bfloat162float(__float2bfloat16_rn(__bfloat162float(qb[t * qs_.t + d]) * scale));
  };
  uint32_t qa[KSTEPS][4];  // A fragments of the warp's 16 scaled query rows
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = rows[i % 2], d = kk * 16 + tig * 2 + (i / 2) * 8;
      qa[kk][i] = pack(q_at(t, d), q_at(t, d + 1));
    }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const bf16 zero = __float2bfloat16_rn(0.f);
  const int k_end = causal ? min(seq, q0 + kRowsQ) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kRowsK) {
    __syncthreads();  // the previous tile's fragments are read
    for (int e = tid; e < kRowsK * DP; e += kThreadsBf16) {
      const int r = e / DP, d = e % DP, s = k0 + r;
      const bool in = s < seq && d < dim;
      ks[r][d] = in ? kb[s * ks_.t + d] : zero;
      vs[r][d] = in ? vb[s * vs_.t + d] : zero;
    }
    __syncthreads();

    float sc[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const bf16* row = &ks[8 * j + g][kk * 16 + tig * 2];
        mma(sc[j], qa[kk], *reinterpret_cast<const uint32_t*>(row),
            *reinterpret_cast<const uint32_t*>(row + 8));
      }
    }

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // accumulator elements 2r, 2r + 1 are row r
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int s = k0 + 8 * j + tig * 2 + c;
          float& x = sc[j][2 * r + c];
          if (s >= seq || (causal && s > rows[r])) x = -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sc[j][2 * r + c];
          x = expf(x - m_use);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < kRowsK / 16; ++kk) {  // 16 keys per step
      // the score fragments of key tiles 2 kk and 2 kk + 1 are the A fragment;
      // P = hi + lo in two bf16 parts keeps about 16 bits of each probability
      const float* p0 = sc[2 * kk];
      const float* p1 = sc[2 * kk + 1];
      uint32_t hi[4], lo[4];
      split(p0[0], p0[1], hi[0], lo[0]);
      split(p0[2], p0[3], hi[1], lo[1]);
      split(p1[0], p1[1], hi[2], lo[2]);
      split(p1[2], p1[3], hi[3], lo[3]);
      const int s = 16 * kk + tig * 2;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const int d = 8 * n + g;
        const uint32_t b0 = pack(vs[s][d], vs[s + 1][d]);
        const uint32_t b1 = pack(vs[s + 8][d], vs[s + 9][d]);
        mma(acc[n], hi, b0, b1);
        mma(acc[n], lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= seq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    if (lse != nullptr && tig == 0)
      lse[((size_t)b * heads + h) * seq + rows[r]] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
    bf16* out = o + (((size_t)b * seq + rows[r]) * heads + h) * dim;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * n + tig * 2 + c;
        if (d < dim) out[d] = __float2bfloat16_rn(acc[n][2 * r + c] * inv);
      }
  }
}

// ---------------------------------------------------------------- fp32, FMA

constexpr int kThreadsF32 = 256;  // 16 x 16 threads: 4 query rows x 4 keys each

template <int DP>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (3 * kRowsQ * (DP + 1) + kRowsQ * (kRowsK + 1));
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides qs_,
                     Strides ks_, Strides vs_, int seq, int heads, int dim, float scale,
                     int causal) {
  constexpr int LD = DP + 1;  // padded rows: the 16 key rows a half-warp reads hit 16 banks
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kRowsQ][LD], pre-scaled
  float* ks = qs + kRowsQ * LD;      // [kRowsK][LD]
  float* vs = ks + kRowsK * LD;      // [kRowsK][LD]
  float* ps = vs + kRowsK * LD;      // [kRowsQ][kRowsK + 1]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tx = lane % 16;
  const int ty = (tid / 32) * 2 + lane / 16;
  const int q0 = blockIdx.x * kRowsQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + h * ks_.h;
  const float* vb = v + b * vs_.b + h * vs_.h;

  for (int e = tid; e < kRowsQ * DP; e += kThreadsF32) {
    const int r = e / DP, d = e % DP, t = q0 + r;
    qs[r * LD + d] = (t < seq && d < dim) ? qb[t * qs_.t + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(seq, q0 + kRowsQ) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kRowsK) {
    __syncthreads();  // the previous tile's P.V is done with ks, vs and ps
    for (int e = tid; e < kRowsK * DP; e += kThreadsF32) {
      const int r = e / DP, d = e % DP, s = k0 + r;
      const bool in = s < seq && d < dim;
      ks[r * LD + d] = in ? kb[s * ks_.t + d] : 0.f;
      vs[r * LD + d] = in ? vb[s * vs_.t + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = k0 + tx + 16 * j;
        if (s >= seq || (causal && s > t)) sc[i][j] = -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_use);
        ps[(4 * ty + i) * (kRowsK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int s = 0; s < kRowsK; ++s) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(4 * ty + i) * (kRowsK + 1) + s];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[s * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= seq) continue;
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * heads + h) * seq + t] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    float* row = o + (((size_t)b * seq + t) * heads + h) * dim;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dim) row[d] = l[i] > 0.f ? acc[i][c] / l[i] : 0.f;
    }
  }
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;  // [B, H, T] or null
  int batch, seq, heads, dim;
  Strides qs, ks, vs;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int DP>
int launch_bf16(const Args& a) {
  const dim3 grid((a.seq + kRowsQ - 1) / kRowsQ, a.heads, a.batch);
  flash_fwd_bf16_kernel<DP><<<grid, kThreadsBf16, 0, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.qs, a.ks, a.vs, a.seq,
      a.heads, a.dim, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_f32(const Args& a) {
  auto kernel = flash_fwd_f32_kernel<DP>;
  const size_t smem = smem_bytes_f32<DP>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.seq + kRowsQ - 1) / kRowsQ, a.heads, a.batch);
  kernel<<<grid, kThreadsF32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.qs, a.ks, a.vs, a.seq,
      a.heads, a.dim, a.scale, a.causal);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, bool is_bf16) {
  if (a.dim <= 32) return is_bf16 ? launch_bf16<32>(a) : launch_f32<32>(a);
  if (a.dim <= 64) return is_bf16 ? launch_bf16<64>(a) : launch_f32<64>(a);
  return is_bf16 ? launch_bf16<128>(a) : launch_f32<128>(a);
}

}  // namespace

extern "C" int acx_attention_max_dim() { return kMaxDim; }

// q, k, v: [B, T, H, D] views with contiguous D and the given element strides
// (batch, time, head); o: contiguous [B, T, H, D].  All four in one dtype (bf16
// when is_bf16, else fp32).  Scores use q * scale; causal masks keys after the
// query.  lse: contiguous fp32 [B, H, T] for each row's log-sum-exp, or null.
extern "C" int acx_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 float* lse, int batch, int seq, int heads, int dim,
                                 long long q_sb, long long q_st, long long q_sh,
                                 long long k_sb, long long k_st, long long k_sh,
                                 long long v_sb, long long v_st, long long v_sh,
                                 float scale, int causal, int is_bf16, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || dim <= 0 || dim > kMaxDim || heads > 65535 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, batch, seq, heads, dim, {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh},
               {v_sb, v_st, v_sh}, scale, causal, (cudaStream_t)stream};
  return dispatch(a, is_bf16 != 0);
}
