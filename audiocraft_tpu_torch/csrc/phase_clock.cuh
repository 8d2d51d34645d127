// The per-phase cycle counter that the kernels' measurement instances carry
// (K1 in rvq.cu, K4 in seanet.cu).  Everything here has internal linkage:
// each source that includes it gets its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kPhases = 8;  // phases the cycle counter can hold (2 slots each)

__device__ __forceinline__ unsigned long long cycles() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t));
  return t;
}

// The per-phase cycle counter: with kClocks, thread 0 of each block sums the
// %clock64 cycles of each phase, barrier included, and lane 0 of each warp
// the cycles it spent on the phase's own work, up to the barrier; flush()
// adds the sums to clocks[phase] and clocks[kPhases + phase] once, at the
// block's end, so that the counter's own memory traffic stays out of the
// phases.  Without kClocks (the production instances) it compiles to nothing.
template <bool kClocks>
struct PhaseClock {
  unsigned long long* clocks;
  unsigned long long mark, lapped[kPhases], worked[kPhases];
  __device__ explicit PhaseClock(unsigned long long* c) : clocks(c), mark(kClocks ? cycles() : 0) {
    if constexpr (kClocks) {
#pragma unroll
      for (int i = 0; i < kPhases; ++i) lapped[i] = worked[i] = 0;
    }
  }
  __device__ void work(int phase) {   // before the phase's barrier
    if constexpr (kClocks) worked[phase] += cycles() - mark;
  }
  __device__ void lap(int phase) {    // after it
    if constexpr (kClocks) {
      const unsigned long long now = cycles();
      lapped[phase] += now - mark;
      mark = now;
    }
  }
  __device__ void flush() {
    if constexpr (kClocks) {
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int i = 0; i < kPhases; ++i) {
          if (threadIdx.x == 0) atomicAdd(clocks + i, lapped[i]);
          atomicAdd(clocks + kPhases + i, worked[i]);
        }
      }
    }
  }
};

}  // namespace
