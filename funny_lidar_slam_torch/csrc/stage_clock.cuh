// Per-stage cycle counts of a one-block kernel, for profiling builds only.
//
// Built with -DFLS_STAGE_CLOCKS (tools/profile_torch_loops.py --stages),
// each thread keeps a StageClock; `mark(i)` adds the SM cycles since the
// previous mark to counter i, and thread 0 writes its kStageClocks counters
// as floats after the kernel's output. Without the macro (and in nvcc's
// host pass) every call is empty and compiles to nothing.
#pragma once

constexpr int kStageClocks = 16;

struct StageClock {
#if defined(FLS_STAGE_CLOCKS) && defined(__CUDA_ARCH__)
  long long last, acc[kStageClocks];
  __device__ StageClock() : last(clock64()) {
    for (int i = 0; i < kStageClocks; ++i) acc[i] = 0;
  }
  __device__ void mark(int i) {
    const long long now = clock64();
    acc[i] += now - last;
    last = now;
  }
  __device__ void write(float* dst) const {
    if (threadIdx.x == 0)
      for (int i = 0; i < kStageClocks; ++i) dst[i] = static_cast<float>(acc[i]);
  }
#else
  __device__ void mark(int) {}
  __device__ void write(float*) const {}
#endif
};
