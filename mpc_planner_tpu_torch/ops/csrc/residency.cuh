// How many one-warp blocks of K1 or K3 the card holds at once, by shared
// memory (their scarce resource): the launchers stage an element's QP into
// shared memory only where the whole batch is resident even so. CUDA only.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mpc {

constexpr int64_t kMaxBlockSharedBytes = 227 * 1024;  // the most a block can ask for on sm_90

// Blocks with `bytes` of dynamic shared memory each that fit the current
// device at once (0 if one block does not fit); 32 blocks an SM at most.
inline int64_t resident_blocks(int64_t bytes) {
  if (bytes > kMaxBlockSharedBytes) return 0;
  int device = 0, sms = 0, per_sm = 0, reserved = 0;
  if (cudaGetDevice(&device) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess
      || cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device) != cudaSuccess
      || cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device) != cudaSuccess)
    return 0;
  const int64_t blocks = per_sm / (bytes + reserved);
  return sms * (blocks < 32 ? blocks : 32);
}

inline bool all_resident(int64_t B, int64_t bytes) { return B <= resident_blocks(bytes); }

}  // namespace mpc
