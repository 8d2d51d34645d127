// What the attention kernels share: the forward (attention.cu, K3f) and the
// backward (attention_bwd.cu, K3b).  Tiles of 64 rows of one (batch, head)
// stream from a [B, T, H, D] view (read by strides, D contiguous) into
// shared memory by 16-byte cp.async copies, with rows padded to D + 8 bf16 so
// that the eight 16-byte rows one ldmatrix phase reads fall in distinct
// banks; mma.sync m16n8k16 takes its operands by ldmatrix.  Everything here
// has internal linkage: each source that includes it gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;      // rows of every streamed tile
constexpr int kMaxDim = 128;   // widest head a block holds
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of a [B, T, H, D] view; D is contiguous
  long long b, t, h;
};

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// d += a . b for a 16x16 bf16 A (row), a 16x8 bf16 B (col), fp32 16x8 D
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// This thread's copies but the newest N groups have landed; the "memory"
// clobber keeps the compiler from moving shared-memory reads above the wait.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows r0 .. r0 + ROWS - 1 of x (one batch and head, row stride st) into
// tile[ROWS][DP + 8] by THREADS threads, 16 bytes per copy; rows >= seq and
// features >= dim zero.  A thread always copies the same pieces of a tile,
// which scale_tile relies on.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* x, long long st, int r0,
                                          int seq, int dim) {
  constexpr int LD = DP + 8, CH = DP / 8;
  static_assert(ROWS * CH % THREADS == 0, "a tile is a whole number of copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS, r = e / CH, c = e % CH, t = r0 + r;
    const bool in = t < seq && 8 * c < dim;
    cp_async16(tile + r * LD + 8 * c, in ? x + t * st + 8 * c : x, in);
  }
}

// The pieces this thread copied with load_tile, once landed: x -> round(x * scale)
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void scale_tile(bf16* tile, float scale) {
  constexpr int LD = DP + 8, CH = DP / 8;
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS, r = e / CH, c = e % CH;
    uint4* p = reinterpret_cast<uint4*>(tile + r * LD + 8 * c);
    uint4 u = *p;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *p = u;
  }
}

template <int DP>
__host__ __device__ constexpr int tile_elems() { return kRows * (DP + 8); }

// Fragment addressing.  For a tile X with row length LD, lane l reads at
// X + (R + ra) * LD + C + ca ("A form": the A fragment of rows R .. R + 15 at
// depth C .. C + 15, or with ldsm_t the B fragments of depth rows R .. R + 15
// and columns C .. C + 15) or at X + (R + rb) * LD + C + cb ("B form": the B
// fragments of the rows R .. R + 15 as columns, at depth C .. C + 15).
struct Lanes {
  int ra, ca, rb, cb;
  __device__ Lanes(int lane)
      : ra(((lane >> 3) & 1) * 8 + (lane & 7)), ca((lane >> 4) * 8),
        rb((lane >> 4) * 8 + (lane & 7)), cb(((lane >> 3) & 1) * 8) {}
};

// Output rows of one warp: 16 x DP fp32 accumulators in mma's fragment layout,
// rows row0 + g and row0 + g + 8, written as bf16 pairs where row < seq, d < dim.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[DP / 8][4], int row0,
                                           int g, int tig, int b, int h, int seq, int heads,
                                           int dim, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row0 + g + 8 * half;
    if (t >= seq) continue;
    bf16* row = out + (((size_t)b * seq + t) * heads + h) * dim;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * tig;
      if (d < dim)
        *reinterpret_cast<__nv_bfloat162*>(row + d) =
            __floats2bfloat162_rn(mul * acc[n][2 * half], mul * acc[n][2 * half + 1]);
    }
  }
}

// every row starts on 16 bytes: `per16` elements to 16 bytes (8 bf16, 4 fp32)
bool rows_aligned(const void* x, Strides s, int per16 = 8) {
  return (uintptr_t)x % 16 == 0 && s.b % per16 == 0 && s.t % per16 == 0 && s.h % per16 == 0;
}

// A kernel with its block size and dynamic shared memory, the latter allowed
template <typename K>
struct Launch {
  K kernel;
  int threads;
  size_t smem;
  cudaError_t prepare() const {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }
};

template <typename K>
Launch<K> make_launch(K kernel, int threads, size_t smem) {
  return Launch<K>{kernel, threads, smem};
}

// What a launch uses, into out[5]: registers per thread, shared memory per
// block (bytes), blocks resident per SM, threads per block, local (spilled)
// bytes per thread.
template <typename L>
int describe(const L& l, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = l.prepare();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, l.kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, l.threads, l.smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)(attr.sharedSizeBytes + l.smem);
  out[2] = blocks;
  out[3] = l.threads;
  out[4] = (int)attr.localSizeBytes;
  return 0;
}

// The width class of a head: the kernels hold 32, 64 or 128 features
template <typename F>
int by_width(int dim, F&& f) {
  if (dim <= 0 || dim > kMaxDim) return (int)cudaErrorInvalidValue;
  if (dim <= 32) return f(std::integral_constant<int, 32>{});
  if (dim <= 64) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, 128>{});
}

}  // namespace
