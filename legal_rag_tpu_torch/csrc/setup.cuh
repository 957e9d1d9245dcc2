// Per-launch host work shared by every kernel's C entry point.
//
// A launch must land on the tensor's card, and a kernel that takes more
// than 48 KB of dynamic shared memory needs its limit raised first. Both
// are set up once and then only checked: the device is made current
// only when it is not already (cudaGetDevice reads a thread-local value),
// and each kernel's shared-memory limit is raised to the block maximum
// once per device, so later launches skip cudaFuncSetAttribute.

#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace setup {

// The most dynamic shared memory a block can take on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;

// Make ``device`` the calling thread's current device if it is not.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

// Raise ``kernel``'s dynamic shared-memory limit to kMaxSmemBytes, once
// per device: ``done`` keeps one bit a device (devices 0-63), and each
// call site passes its own (a static beside the kernel it launches).
// Two threads may both set the attribute the first time; that is
// harmless.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel* kernel, int device,
                           std::atomic<unsigned long long>& done) {
  if (device < 0 || device > 63) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << device;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The device's multiprocessor count, read once per device.
inline cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> cached[64];  // zero until read
  if (device < 0 || device > 63) return cudaErrorInvalidDevice;
  int n = cached[device].load(std::memory_order_relaxed);
  if (n == 0) {
    cudaError_t err =
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cached[device].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

}  // namespace setup
