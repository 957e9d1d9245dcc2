// P: a compile-and-launch probe of the card's toolchain, and of the tie
// rule that K3 relies on.
//
// Replaces the TPU hardware test's compiler probe
// (tests/test_tpu_hardware.py test_pallas_argmax_last_occurrence_assumption),
// which found that an in-kernel argmax on the TPU resolves ties to the
// LAST occurrence. Here each row of x [n_rows, n_cols] fp32 reduces to
// its (max, lowest index) by the same comparison K3's selection uses;
// a row with equal maxima at columns 33 and 200 gives 33.
//
// One block per row: a strided scan per thread, then a butterfly over
// the warp's lanes and a pass over the block's warps in shared memory.
//
// What bounds it: at [8, 256] the device work is a few microseconds and
// the bytes take nanoseconds, so a call costs what the host pays to
// launch it. The entry point therefore does no per-call setup: it makes
// the device current only when it is not (setup.cuh), and its wrapper
// takes CudaKernel's lean path (the library and its ctypes signatures
// loaded once, the raw stream handle, a plain launch count).

#include <cfloat>
#include <climits>

#include <cuda_runtime.h>

#include "setup.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void keep_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
argmax_rows_kernel(const float* __restrict__ x, int n_cols,
                   int* __restrict__ out) {
  __shared__ float wv[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  const float* row = x + static_cast<long long>(blockIdx.x) * n_cols;
  float v = -FLT_MAX;
  int i = INT_MAX;
  for (int c = threadIdx.x; c < n_cols; c += kThreads) keep_better(v, i, row[c], c);
  for (int m = 16; m > 0; m >>= 1) {
    keep_better(v, i, __shfl_xor_sync(kFullMask, v, m),
                __shfl_xor_sync(kFullMask, i, m));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    wv[warp] = v;
    wi[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) keep_better(v, i, wv[w], wi[w]);
    out[blockIdx.x] = i;
  }
}

}  // namespace

// x [n_rows, n_cols] fp32 row-major, out [n_rows] int32. Returns the
// CUDA error of the launch (0 on success); it runs asynchronously on
// ``stream``.
extern "C" int argmax_probe_launch(const void* x, int n_rows, int n_cols,
                                   void* out, int device, void* stream) {
  if (n_rows < 1 || n_cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = setup::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  argmax_rows_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n_cols, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
