// Residual-VQ encode, the argmin chain over n_q codebooks (kernel K1).
//
// Replaces audiocraft_tpu/ops/rvq_pallas.py:_rvq_kernel.  For each codebook q:
//     dist = -((|r|^2 - 2 r.E^T) + |E|^2),  idx = first argmax(dist),  r <- r - E[idx]
// with the residual r carried from one codebook to the next.
//
// Bound on an H100: fp32 FMA.  The work is 2*N*D*K*n_q operations (134 GFLOP
// at N = 64000, D = 128, K = 2048, n_q = 4: 2.0 ms at 67 TFLOP/s) against
// about 38 MB of traffic.  TF32 tensor cores would be faster but round the
// distances differently from the reference, which changes tokens, so the
// kernel stays in fp32 on the CUDA cores.
//
// The first design (64 rows a block, a 4 x 4 register tile fed by scalar
// shared loads, the codebook loaded by scalar ld.global between two barriers
// a 32-feature chunk) took 6.267 ms at that shape on an NVIDIA H100 80GB
// HBM3 at 700 W; its per-phase counter gave codebook wait 36 %, products
// 56 % (8 shared loads per 16 FFMA), argmax epilogue 5 % (PERF.md).  This
// design:
// - One block of 256 threads owns `rows` residual rows (128 while the
//   residual fits beside the ring, else 64, else 32; D up to kRvqMaxDim =
//   1024, the style conditioner's width) and keeps them in shared memory for
//   the whole chain, feature-major: res[f * rows + r], so the residual never
//   goes back to device memory between codebooks.
// - Each thread holds an 8-row x 8-code register tile (64 fp32 sums): rows
//   4 rg .. 4 rg + 3 and rows / 2 + 4 rg .. + 3, codes 4 cg .. + 3 and
//   codes / 2 + 4 cg .. + 3 of a tile of 16384 / rows codes.  Per feature it
//   takes four 128-bit shared loads for 64 FFMA (16 per load, 4 per word).
// - The codebooks arrive transposed and padded, E^T [n_q, Dp, Kp] with Dp a
//   multiple of kChunk and Kp of the code tile (ops/rvq.py:pack_codebooks,
//   built per call), and stream through a ring of kStages chunks of kChunk
//   features x one code tile by 16-byte cp.async copies.  The sequence of
//   chunks runs on over tiles and codebooks, so the next chunk is always in
//   flight while the current one is multiplied; one barrier a chunk.
// - The epilogue forms each distance negated, s = (|r|^2 - 2 r.E) + |E|^2,
//   rounded in the reference's order of operations (dist = -s exactly),
//   keeps a running least s per row over strictly increasing code indices
//   with strict '<', masks codes >= K, and the threads that share a row then
//   reduce by lane shuffles (and through shared memory where a row's threads
//   span two warps) with the lower index winning on equal values: the
//   first-index tie-break of torch.argmax and jnp.argmax.  The order of
//   summation inside r.E and |r|^2 differs from the plain version's.
// - |r|^2 is a reduction over all the block's threads; the residual update
//   reads E[idx] from the untransposed codebook by 128-bit loads (scalar
//   where D % 4 != 0).  Rows >= N load as zeros and are not written.
// The grid is one block per `rows` rows (500 at the main shape, two an SM).
// The counter's instance (acx_rvq_encode_clocks) sums each phase's cycles of
// thread 0 per block and flushes once per block.  After, on the same card:
// 3.017 ms (44.5 TFLOP/s, 66 % of the bound; 2.785 ms at D = 1024, N =
// 8192, K = 1024, n_q = 6, where the first design took 23.5), 125 registers;
// products 61 %, chunk barrier 24 %, argmax epilogue 10 % (PERF.md).
#include <cuda_runtime.h>
#include <math.h>

#include "attention_common.cuh"
#include "phase_clock.cuh"

namespace {

constexpr int kRvqThreads = 256;
constexpr int kTile = 8;              // rows and codes of a thread's register tile
constexpr int kChunk = 16;            // features per streamed chunk
constexpr int kStages = 3;            // chunks in the ring
constexpr int kRvqMaxDim = 1024;      // widest residual row a block holds
constexpr int kRvqSmemLimit = 232448; // the dynamic shared memory a block may use

// Phases of the cycle counter (acx_rvq_encode_clocks)
enum Phase { kLoad, kNorm, kWait, kProducts, kEpilogue, kReduce, kUpdate };

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
// codes of a tile: the threads' 8 x 8 tiles cover rows x codes
__host__ __device__ constexpr int tile_codes(int rows) { return kRvqThreads * kTile * kTile / rows; }
// warps across the threads that share a row: partial bests per row
__host__ __device__ constexpr int row_partials(int rows) {
  return tile_codes(rows) / kTile > 32 ? tile_codes(rows) / kTile / 32 : 1;
}

// Shared bytes of a block: the residual [Dp][rows], the ring [kStages][kChunk]
// [codes], the |r|^2 partials [256], |r|^2 [rows], the partial bests (value,
// index) [row_partials][rows] and the chosen codes [rows].  ops/rvq.py:_smem_bytes
// computes the same.
__host__ constexpr int smem_bytes(int rows, int d) {
  return 4 * (round_up(d, kChunk) * rows + kStages * kChunk * tile_codes(rows) + kRvqThreads +
              rows + 2 * row_partials(rows) * rows + rows);
}

struct Rvq {
  int n, d, k, n_q;
  int dp, kp;   // padded features and codes of the packed E^T
  int vec;      // 16-byte loads of x and E rows (D % 4 == 0, aligned)
};

template <int ROWS, bool kClocks>
__global__ void __launch_bounds__(kRvqThreads, 2)
rvq_encode_kernel(const float* __restrict__ x, const float* __restrict__ et,
                  const float* __restrict__ esq, const float* __restrict__ embed,
                  int* __restrict__ codes, Rvq g, unsigned long long* clocks) {
  constexpr int TC = tile_codes(ROWS);          // 128, 256, 512 codes a tile
  constexpr int CT = TC / kTile;                // threads along the codes
  constexpr int LANES = CT < 32 ? CT : 32;      // lanes of a warp that share a row
  constexpr int NP = row_partials(ROWS);
  constexpr int P = kRvqThreads / ROWS;         // threads a row in the row passes
  constexpr int SLOT = kChunk * TC;             // floats of one ring slot
  extern __shared__ __align__(16) float smem[];
  float* res = smem;                            // [dp][ROWS]
  float* ring = res + (size_t)g.dp * ROWS;      // [kStages][kChunk][TC]
  float* norm = ring + kStages * SLOT;          // [P][ROWS]
  float* xsq = norm + kRvqThreads;              // [ROWS]
  float* part_v = xsq + ROWS;                   // [NP][ROWS]
  int* part_i = reinterpret_cast<int*>(part_v + NP * ROWS);
  int* best_code = part_i + NP * ROWS;          // [ROWS]

  PhaseClock<kClocks> laps(clocks);
  const int tid = threadIdx.x, cg = tid % CT, rg = tid / CT;
  const int row0 = blockIdx.x * ROWS;
  const int tiles = g.kp / TC, dchunks = g.dp / kChunk;

  // the next chunk of the sequence (codebook, code tile, feature chunk) into
  // slot ic % kStages; a cursor, so that no division runs per chunk
  int iq = 0, itile = 0, idc = 0, ic = 0;
  auto issue = [&]() {
    if (iq < g.n_q) {
      const float* src = et + ((size_t)iq * g.dp + idc * kChunk) * g.kp + itile * TC;
      float* dst = ring + (ic % kStages) * SLOT;
#pragma unroll
      for (int i = 0; i < SLOT / 4 / kRvqThreads; ++i) {
        const int e = tid + i * kRvqThreads, f = e / (TC / 4), m = e % (TC / 4);
        cp_async16(dst + f * TC + 4 * m, src + (size_t)f * g.kp + 4 * m, true);
      }
      if (++idc == dchunks) {
        idc = 0;
        if (++itile == tiles) itile = 0, ++iq;
      }
    }
    ++ic;
    cp_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue();

  // the residual tile, feature-major; lanes take consecutive rows so that the
  // stores into a feature's row fall in distinct banks
  if (g.vec) {
    for (int e = tid; e < ROWS * (g.d / 4); e += kRvqThreads) {
      const int r = e % ROWS, f = 4 * (e / ROWS);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < g.n) v = *reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * g.d + f);
      res[f * ROWS + r] = v.x, res[(f + 1) * ROWS + r] = v.y;
      res[(f + 2) * ROWS + r] = v.z, res[(f + 3) * ROWS + r] = v.w;
    }
    for (int e = ROWS * g.d + tid; e < ROWS * g.dp; e += kRvqThreads) res[e] = 0.f;
  } else {
    for (int e = tid; e < ROWS * g.dp; e += kRvqThreads) {
      const int r = e % ROWS, f = e / ROWS;
      res[e] = row0 + r < g.n && f < g.d ? x[(size_t)(row0 + r) * g.d + f] : 0.f;
    }
  }
  laps.work(kLoad);
  __syncthreads();
  laps.lap(kLoad);

  int c = 0;   // the chunk being multiplied
  for (int q = 0; q < g.n_q; ++q) {
    // |r|^2: P partial sums a row over strided features, then their sum
    {
      const int r = tid % ROWS, part = tid / ROWS;
      float s = 0.f;
      for (int f = part; f < g.d; f += P) s = fmaf(res[f * ROWS + r], res[f * ROWS + r], s);
      norm[part * ROWS + r] = s;
    }
    laps.work(kNorm);
    __syncthreads();
    if (tid < ROWS) {
      float s = norm[tid];
#pragma unroll
      for (int p = 1; p < P; ++p) s += norm[p * ROWS + tid];
      xsq[tid] = s;   // read in the epilogue, after the next chunk's barrier
    }
    laps.lap(kNorm);

    float best[kTile];
    int best_idx[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) best[i] = INFINITY, best_idx[i] = 0;

    for (int t = 0; t < tiles; ++t) {
      float acc[kTile][kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;

      for (int dc = 0; dc < dchunks; ++dc, ++c) {
        cp_wait<kStages - 2>();   // this thread's copies of chunk c have landed
        laps.work(kWait);
        __syncthreads();          // everyone's have, and slot (c - 1) % kStages is free
        issue();
        laps.lap(kWait);
        const float* rs = res + (size_t)dc * kChunk * ROWS;
        const float* bs = ring + (c % kStages) * SLOT;
#pragma unroll
        for (int f = 0; f < kChunk; ++f) {
          const float4 a0 = *reinterpret_cast<const float4*>(rs + f * ROWS + 4 * rg);
          const float4 a1 = *reinterpret_cast<const float4*>(rs + f * ROWS + ROWS / 2 + 4 * rg);
          const float4 b0 = *reinterpret_cast<const float4*>(bs + f * TC + 4 * cg);
          const float4 b1 = *reinterpret_cast<const float4*>(bs + f * TC + TC / 2 + 4 * cg);
          const float a[kTile] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float b[kTile] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < kTile; ++i)
#pragma unroll
            for (int j = 0; j < kTile; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        laps.lap(kProducts);
      }

      // s = (|r|^2 - 2 r.E) + |E|^2, the distance negated, rounded as the
      // reference rounds it (2 r.E is exact, so the fma rounds as the
      // subtraction does); the least s over increasing code indices
      const float* eq = esq + (size_t)q * g.kp + t * TC;
      const float4 e0 = *reinterpret_cast<const float4*>(eq + 4 * cg);
      const float4 e1 = *reinterpret_cast<const float4*>(eq + TC / 2 + 4 * cg);
      const float e2[kTile] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
      float xs[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) xs[i] = xsq[(i < 4 ? 0 : ROWS / 2) + 4 * rg + (i & 3)];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int code = t * TC + (j < 4 ? 0 : TC / 2) + 4 * cg + (j & 3);
        if (code >= g.k) continue;
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const float s = __fadd_rn(__fmaf_rn(-2.f, acc[i][j], xs[i]), e2[j]);
          if (s < best[i]) best[i] = s, best_idx[i] = code;
        }
      }
      laps.lap(kEpilogue);
    }

    // the threads of a row: lanes by shuffles, then the warps through shared
    // memory; the lower index wins on equal values
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      float v = best[i];
      int idx = best_idx[i];
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (ov < v || (ov == v && oi < idx)) v = ov, idx = oi;
      }
      if (cg % 32 == 0) {
        const int r = (i < 4 ? 0 : ROWS / 2) + 4 * rg + (i & 3);
        part_v[(cg / 32) * ROWS + r] = v;
        part_i[(cg / 32) * ROWS + r] = idx;
      }
    }
    laps.work(kReduce);
    __syncthreads();
    if (tid < ROWS) {
      float v = part_v[tid];
      int idx = part_i[tid];
#pragma unroll
      for (int p = 1; p < NP; ++p) {
        const float ov = part_v[p * ROWS + tid];
        const int oi = part_i[p * ROWS + tid];
        if (ov < v || (ov == v && oi < idx)) v = ov, idx = oi;
      }
      best_code[tid] = idx;
      if (row0 + tid < g.n) codes[(size_t)q * g.n + row0 + tid] = idx;
    }
    __syncthreads();
    laps.lap(kReduce);

    // r <- r - E[idx], E read in its own [K, D] layout
    const float* eq = embed + (size_t)q * g.k * g.d;
    if (g.vec) {
      for (int e = tid; e < ROWS * (g.d / 4); e += kRvqThreads) {
        const int r = e % ROWS, f = 4 * (e / ROWS);
        const float4 v = *reinterpret_cast<const float4*>(eq + (size_t)best_code[r] * g.d + f);
        res[f * ROWS + r] = __fsub_rn(res[f * ROWS + r], v.x);
        res[(f + 1) * ROWS + r] = __fsub_rn(res[(f + 1) * ROWS + r], v.y);
        res[(f + 2) * ROWS + r] = __fsub_rn(res[(f + 2) * ROWS + r], v.z);
        res[(f + 3) * ROWS + r] = __fsub_rn(res[(f + 3) * ROWS + r], v.w);
      }
    } else {
      for (int e = tid; e < ROWS * g.d; e += kRvqThreads) {
        const int r = e % ROWS, f = e / ROWS;
        res[e] = __fsub_rn(res[e], eq[(size_t)best_code[r] * g.d + f]);
      }
    }
    laps.work(kUpdate);
    __syncthreads();
    laps.lap(kUpdate);
  }
  laps.flush();
}

template <int ROWS, bool kClocks>
int launch(const float* x, const float* et, const float* esq, const float* embed, int* codes,
           Rvq g, int smem, cudaStream_t stream, unsigned long long* clocks, int* info) {
  auto kernel = rvq_encode_kernel<ROWS, kClocks>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.n + ROWS - 1) / ROWS);
  if (info) {
    cudaFuncAttributes fa;
    int blocks = 0;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kRvqThreads, smem);
    if (err != cudaSuccess) return (int)err;
    info[0] = fa.numRegs, info[1] = (int)fa.sharedSizeBytes + smem, info[2] = blocks;
    info[3] = kRvqThreads, info[4] = (int)fa.localSizeBytes, info[5] = ROWS, info[6] = (int)grid.x;
    return 0;
  }
  kernel<<<grid, kRvqThreads, smem, stream>>>(x, et, esq, embed, codes, g, clocks);
  return (int)cudaGetLastError();
}

// The plan for rows of d features: the most rows a block whose shared memory
// fits; {rows, codes a tile, features a chunk, ring stages, shared bytes}, or
// rows = 0 where none fits.  ops/rvq.py:rvq_plan computes the same.
void make_plan(int d, int* plan) {
  plan[0] = 0;
  for (int rows = 128; rows >= 32; rows /= 2) {
    if (smem_bytes(rows, d) <= kRvqSmemLimit) {
      plan[0] = rows, plan[1] = tile_codes(rows), plan[2] = kChunk, plan[3] = kStages;
      plan[4] = smem_bytes(rows, d);
      return;
    }
  }
}

// Checks the sizes and the caller's plan against make_plan's, then launches
// (or, with info, describes) the instance for the plan's rows.
template <bool kClocks>
int run(const float* x, const float* et, const float* esq, const float* embed, int* codes, int n,
        int d, int k, int n_q, const int* plan, void* stream, unsigned long long* clocks,
        int* info) {
  if (n <= 0 || d <= 0 || d > kRvqMaxDim || k <= 0 || n_q <= 0 || !plan)
    return (int)cudaErrorInvalidValue;
  int own[5];
  make_plan(d, own);
  for (int i = 0; i < 5; ++i)
    if (own[i] != plan[i]) return (int)cudaErrorInvalidValue;
  Rvq g{n, d, k, n_q, round_up(d, kChunk), round_up(k, own[1]), 0};
  g.vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(embed) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (own[0]) {
    case 128: return launch<128, kClocks>(x, et, esq, embed, codes, g, own[4], s, clocks, info);
    case 64: return launch<64, kClocks>(x, et, esq, embed, codes, g, own[4], s, clocks, info);
    case 32: return launch<32, kClocks>(x, et, esq, embed, codes, g, own[4], s, clocks, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int acx_rvq_max_dim() { return kRvqMaxDim; }

// x [n, d] fp32; et [n_q, Dp, Kp] and esq [n_q, Kp] fp32, the codebooks
// transposed and padded by ops/rvq.py:pack_codebooks for this plan; embed
// [n_q, k, d] fp32 as given; codes [n_q, n] int32.  plan[5] as make_plan
// gives it, or cudaErrorInvalidValue.
extern "C" int acx_rvq_encode(const float* x, const float* et, const float* esq,
                              const float* embed, int* codes, int n, int d, int k, int n_q,
                              const int* plan, void* stream) {
  return run<false>(x, et, esq, embed, codes, n, d, k, n_q, plan, stream, nullptr, nullptr);
}

// The same launch with the per-phase cycle counter on: clocks[2 * kPhases]
// (zeroed by the caller) collects each phase's cycles of thread 0, summed over
// the blocks, then each warp's own work up to the phase's barrier, summed over
// the warps.  A measurement: no model path calls it.
extern "C" int acx_rvq_encode_clocks(const float* x, const float* et, const float* esq,
                                     const float* embed, int* codes, int n, int d, int k,
                                     int n_q, const int* plan, void* clocks, void* stream) {
  return run<true>(x, et, esq, embed, codes, n, d, k, n_q, plan, stream,
                   static_cast<unsigned long long*>(clocks), nullptr);
}

// What the production instance for this launch uses, into out[7]: registers,
// shared bytes, blocks per SM, threads, spilled bytes, rows a block, blocks
// launched; nothing is launched.
extern "C" int acx_rvq_info(int n, int d, int k, int n_q, const int* plan, int* out) {
  return run<false>(nullptr, nullptr, nullptr, nullptr, nullptr, n, d, k, n_q, plan, nullptr,
                    nullptr, out);
}

extern "C" const char* acx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
