// Data-movement probe (P1): the operations that
// scripts/probe_mosaic_ops.py:try_kernel and k_dotg try on the TPU, as CUDA
// kernels on bf16.  There the question was which reshapes, strided slices
// and 3-D contractions the Mosaic compiler lowers; here each operation is a
// kernel that must build, launch and equal its plain torch result
// (apps/probe_ops.py prints OK or FAIL for each).
//
// - gather (replaces try_kernel's reshapes and slices): y[r, c] =
//   x[r * row_stride + c * col_stride] over the output's [rows, cols].  A
//   merge or split reshape of a contiguous array is the gather with
//   row_stride = cols, col_stride = 1; [:, ::k] and [::k, :] are the gathers
//   with col_stride k or row_stride k * width.  Bound by bytes: each output
//   written once, each 32-byte sector of x that holds a wanted element read
//   once ([:, ::4] reads all of x).  At the probe's 64-128 KB the bound is
//   tens of nanoseconds, under a launch, so there the launch sets the pace.
//   Design: 16-byte vectors.  Where the path allows it (ops/probe.py:
//   gather_plan; x on 16 bytes, cols and row_stride multiples of 8) a thread
//   reads k whole uint4s of a row (k = the column stride, 1, 2, 4 or 8), keeps
//   every k-th element and stores one uint4; the threads of a warp read
//   neighbouring vectors.  The grid strides over the work with at most 16
//   blocks of 128 threads an SM (a 256 MiB input launches 2,112 blocks, not
//   millions), each thread then carrying 4 / k vectors a grid's width apart,
//   so 4 loads of 16 bytes are in flight per thread; a small copy has one
//   vector a thread over as many blocks as it fills, since a few SMs moving
//   the probe's 64 KB take 0.4 us longer than many.  Any other stride keeps
//   one element a thread, on the same grid-stride loop.
// - contract (replaces k_dotg): the merge [M * S, C] -> [M, S, C] and a
//   dot_general over (slot, channel) with taps [S, C, N]: y[m, n] =
//   sum_k x[m, k] taps[k, n], K = S * C, bf16 in, fp32 sums, y rounded to
//   bf16 once at the store.  At K = 256, N = 32 it is 32 FLOP a byte of x:
//   bound by bytes, but only just within reach of fp32 FMA, so the products
//   run on the tensor cores.  Design: each block of 4 warps stages taps once
//   in shared memory (16 KB at the probe's shape, rows padded by 8 bf16 so
//   that one ldmatrix phase hits 8 distinct bank groups); each warp then
//   walks 16-row tiles of x, streamed by 16-byte cp.async (with a 256-byte
//   L2 prefetch hint) into its own two-stage ring (the next tile lands while
//   this one is multiplied), takes A by ldmatrix and B by ldmatrix.trans,
//   runs mma.sync m16n8k16 bf16 -> fp32 over K and stores the tile.  The
//   warps of a block meet only once, after taps land.  The probe's M = 128
//   is 8 tiles, 2 blocks; at large M each warp walks many tiles (8 warps a
//   block and 3 stages took 3 % less at M = 262,144 and 26 % more at 128).
//   Shapes the tensor-core path does not take (K % 16, K > 512, N other
//   than the probe's 32, operands off 16 bytes) keep the first kernel: one
//   output a thread, fp32 FMA.
#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;       // gather block (and the FMA contraction's)
constexpr int kBlocksPerSm = 16;    // gather blocks an SM at most (2,048 threads)
constexpr int kVectors = 4;         // 16-byte loads in flight per gather thread
constexpr int kWarps = 4;           // tensor-core contraction block
constexpr int kCols = 32;           // its width N (4 n-tiles of 8)
constexpr int kMaxDevices = 64;

int sm_count() {
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 1;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 1;
}

int grid_for(long long work, long long per_block, int cap) {
  const long long want = (work + per_block - 1) / per_block;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

// ----------------------------------------------------------------- gather

// Element e (a bf16) of the K uint4s held as 4 * K 32-bit words
template <int K>
__device__ __forceinline__ uint32_t element(const uint32_t (&w)[4 * K], int e) {
  return (w[e >> 1] >> (16 * (e & 1))) & 0xffffu;
}

// Vector v of y (row r = v / per_row, vector c8 of the row) from the K
// uint4s of x at r * row_stride + 8 * K * c8: every K-th element.  Each
// thread carries U = kVectors / K vectors per turn, a grid's width apart,
// loads before stores; below the block cap a thread has one vector, so a
// small copy spreads over as many SMs as it can fill.
template <int K>
__global__ void __launch_bounds__(kThreads)
gather_vec_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, unsigned n_vec,
                  unsigned per_row, long long row_vecs) {
  constexpr int U = kVectors / K > 0 ? kVectors / K : 1;
  const unsigned width = gridDim.x * kThreads;
  for (unsigned base = blockIdx.x * kThreads + threadIdx.x; base < n_vec; base += U * width) {
    uint32_t w[U][4 * K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned v = base + u * width;
      if (v >= n_vec) continue;
      const unsigned r = v / per_row, c8 = v - r * per_row;
      const uint4* src = x + (long long)r * row_vecs + (long long)c8 * K;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const uint4 q = __ldg(src + i);
        w[u][4 * i] = q.x, w[u][4 * i + 1] = q.y, w[u][4 * i + 2] = q.z, w[u][4 * i + 3] = q.w;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned v = base + u * width;
      if (v >= n_vec) continue;
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = element<K>(w[u], 2 * j * K) | (element<K>(w[u], (2 * j + 1) * K) << 16);
      __stcs(y + v, make_uint4(o[0], o[1], o[2], o[3]));
    }
  }
}

// One element a thread; 32-bit indices (I = unsigned) where the count
// allows: a 64-bit divide costs a [1, 1] launch 0.18 us.
template <typename I>
__global__ void __launch_bounds__(kThreads)
gather_scalar_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, I n, I cols,
                     long long row_stride, long long col_stride) {
  const I step = (I)gridDim.x * kThreads;
  for (I i = (I)blockIdx.x * kThreads + threadIdx.x; i < n; i += step) {
    const I r = i / cols, c = i - r * cols;
    y[i] = x[(long long)r * row_stride + (long long)c * col_stride];
  }
}

// ---------------------------------------------------------- contraction

// One output a thread, fp32 FMA over the whole row of x and column of taps:
// the shapes the tensor-core kernel does not take.
__global__ void __launch_bounds__(kThreads)
contract_fma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ taps,
                    bf16* __restrict__ y, int m_rows, int depth, int n_cols) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m_rows * n_cols) return;
  const int m = i / n_cols, n = i - m * n_cols;
  const bf16* xr = x + (size_t)m * depth;
  float acc = 0.f;
  for (int k = 0; k < depth; ++k)
    acc = fmaf(__bfloat162float(xr[k]), __bfloat162float(taps[(size_t)k * n_cols + n]), acc);
  y[i] = __float2bfloat16_rn(acc);
}

__host__ __device__ constexpr int pad8(int n) { return n + 8; }

// Shared memory: taps [depth][N + 8], then each warp's ring of 2 tiles
// [16][depth + 8]
size_t contract_smem(int depth) {
  return sizeof(bf16) * ((size_t)depth * pad8(kCols) + (size_t)kWarps * 2 * 16 * pad8(depth));
}

// 16 rows of x from row t * 16 into tile [16][depth + 8], by the warp's
// lanes, 16 bytes a copy with a 256-byte L2 prefetch hint; rows >= m_rows
// zero
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* x, long long t, int m_rows,
                                          int depth, int lane) {
  const int chunks = depth / 8, lda = pad8(depth);
  for (int e = lane; e < 16 * chunks; e += 32) {
    const int r = e / chunks, c = e - r * chunks;
    const long long row = t * 16 + r;
    const bool in = row < m_rows;
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(tile + r * lda + 8 * c)), "l"(in ? x + row * depth + 8 * c : x),
                    "r"(in ? 16 : 0) : "memory");
  }
}

// y [m_rows, 32] = x [m_rows, depth] . taps [depth, 32] on the tensor cores
// (one ldmatrix.trans gives the B fragments of 2 of the 4 n-tiles)
__global__ void __launch_bounds__(kWarps * 32)
contract_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ taps,
                    bf16* __restrict__ y, int m_rows, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int N = kCols, NT = N / 8, LDB = pad8(N);
  const int lda = pad8(depth);
  bf16* tb = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* ring = tb + depth * LDB + warp * 2 * 16 * lda;

  for (int e = threadIdx.x; e < depth * (N / 8); e += kWarps * 32) {
    const int k = e / (N / 8), c = e - k * (N / 8);
    cp_async16(tb + k * LDB + 8 * c, taps + (size_t)k * N + 8 * c, true);
  }
  cp_commit();
  const long long tiles = (m_rows + 15) / 16, stride = (long long)gridDim.x * kWarps;
  long long t = (long long)blockIdx.x * kWarps + warp;
  if (t < tiles) load_rows(ring, x, t, m_rows, depth, lane);
  cp_commit();
  cp_wait<0>();
  __syncthreads();  // taps, copied by every thread, and each warp's first tile

  const Lanes L(lane);
  const int g = lane >> 2, tig = lane & 3;
  for (int s = 0; t < tiles; t += stride, s ^= 1) {
    if (t + stride < tiles) load_rows(ring + (s ^ 1) * 16 * lda, x, t + stride, m_rows, depth, lane);
    cp_commit();
    cp_wait<1>();
    __syncwarp();  // the warp's copies of tile t have landed

    const bf16* a = ring + s * 16 * lda;
    float acc[NT][4] = {};
    for (int k = 0; k < depth; k += 16) {
      uint32_t af[4];
      ldsm(af, a + L.ra * lda + k + L.ca);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        ldsm_t(bf, tb + (k + L.ra) * LDB + 8 * n + L.ca);
        mma(acc[n], af, bf[0], bf[1]);
        mma(acc[n + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = t * 16 + g + 8 * half;
      if (row >= m_rows) continue;
      bf16* out = y + row * N + 2 * tig;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(out + 8 * n) = pack(acc[n][2 * half], acc[n][2 * half + 1]);
    }
    __syncwarp();  // every lane is done with stage s before it is refilled
  }
}

int launch_contract_mma(const bf16* x, const bf16* taps, bf16* y, int m_rows, int depth,
                        cudaStream_t stream) {
  static bool prepared[kMaxDevices] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  const size_t smem = contract_smem(depth);
  if (dev < kMaxDevices && !prepared[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        contract_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    prepared[dev] = true;
  }
  const int per_sm = (int)(232448 / (smem + 1024)) > 0 ? (int)(232448 / (smem + 1024)) : 1;
  const int grid = grid_for((m_rows + 15) / 16, kWarps, sm_count() * per_sm);
  contract_mma_kernel<<<grid, kWarps * 32, smem, stream>>>(x, taps, y, m_rows, depth);
  return (int)cudaGetLastError();
}

}  // namespace

// y [rows, cols] bf16 gathered from x at r * row_stride + c * col_stride.
// vector (ops/probe.py:gather_plan): k > 0 reads k 16-byte vectors of x for
// each one of y (x on 16 bytes, cols and row_stride multiples of 8,
// col_stride = k, rows * cols < 2^31); 0 moves one element a thread.
extern "C" int acx_probe_gather(const void* x, void* y, int rows, int cols, long long row_stride,
                                long long col_stride, int vector, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * cols;
  const int cap = sm_count() * kBlocksPerSm;
  cudaStream_t st = (cudaStream_t)stream;
  if (vector == 0) {
    const bf16* xb = static_cast<const bf16*>(x);
    bf16* yb = static_cast<bf16*>(y);
    if (n + (long long)cap * kThreads < (1ll << 32))
      gather_scalar_kernel<unsigned><<<grid_for(n, kThreads, cap), kThreads, 0, st>>>(
          xb, yb, (unsigned)n, (unsigned)cols, row_stride, col_stride);
    else
      gather_scalar_kernel<unsigned long long><<<grid_for(n, kThreads, cap), kThreads, 0, st>>>(
          xb, yb, n, cols, row_stride, col_stride);
    return (int)cudaGetLastError();
  }
  if (vector != col_stride || (uintptr_t)x % 16 || (uintptr_t)y % 16 || cols % 8 ||
      row_stride % 8 || n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned n_vec = (unsigned)(n / 8), per_row = (unsigned)(cols / 8);
  const long long row_vecs = row_stride / 8;
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* yv = static_cast<uint4*>(y);
  const int grid = grid_for(n_vec, kThreads, cap);
  switch (vector) {
    case 1: gather_vec_kernel<1><<<grid, kThreads, 0, st>>>(xv, yv, n_vec, per_row, row_vecs); break;
    case 2: gather_vec_kernel<2><<<grid, kThreads, 0, st>>>(xv, yv, n_vec, per_row, row_vecs); break;
    case 4: gather_vec_kernel<4><<<grid, kThreads, 0, st>>>(xv, yv, n_vec, per_row, row_vecs); break;
    case 8: gather_vec_kernel<8><<<grid, kThreads, 0, st>>>(xv, yv, n_vec, per_row, row_vecs); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// y [m_rows, n_cols] = x [m_rows, depth] . taps [depth, n_cols], bf16 in and
// out, fp32 sums (depth = slots * channels of the merged input).  mma
// (ops/probe.py:contract_plan): 1 on the tensor cores (depth % 16 == 0,
// depth <= 512, n_cols 32, x and taps on 16 bytes), 0 on FMA.
extern "C" int acx_probe_contract(const void* x, const void* taps, void* y, int m_rows, int depth,
                                  int n_cols, int mma, void* stream) {
  if (m_rows <= 0 || depth <= 0 || n_cols <= 0) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* tb = static_cast<const bf16*>(taps);
  bf16* yb = static_cast<bf16*>(y);
  cudaStream_t st = (cudaStream_t)stream;
  if (mma == 0) {
    const long long n = (long long)m_rows * n_cols;
    if (n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    contract_fma_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        xb, tb, yb, m_rows, depth, n_cols);
    return (int)cudaGetLastError();
  }
  if (depth % 16 || depth > 512 || n_cols != kCols || (uintptr_t)x % 16 || (uintptr_t)taps % 16 ||
      (uintptr_t)y % 4)
    return (int)cudaErrorInvalidValue;
  return launch_contract_mma(xb, tb, yb, m_rows, depth, st);
}
