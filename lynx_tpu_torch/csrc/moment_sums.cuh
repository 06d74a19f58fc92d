// Shared device code of the particle moment sweep (kernels B5 and B6): the
// 36 sums' count, and the second stage of B6's two-stage reduction (B5
// reduces inside its one launch).
//
// Stage 1 (packed_gram.cu) sums the 36 moments of each setting over a
// split of the cloud and writes them to a (batch, slots, 36) partial
// buffer.  Stage 2, here, sums
// the partials of each setting in a fixed order: levels that each add
// kReduceGroup consecutive slots, until one slot is left.  No shared memory
// and no atomics, so the result is deterministic and the code runs under the
// host build of the tests.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lynx {

constexpr int kSums = 36;          // moments per setting
constexpr int64_t kReduceGroup = 64;  // slots summed by one thread of a level
constexpr int kReduceThreads = 128;

// in: (batch, slots, 36); out: (batch, groups, 36), groups = ceil(slots /
// kReduceGroup).  Output (b, g, k) is the sum of in[b, s, k] over the slots
// s of group g, in slot order.  Neighbouring threads take neighbouring k, so
// a warp reads neighbouring addresses.
template <typename T>
__global__ void reduce_partials_kernel(const T* __restrict__ in, T* __restrict__ out,
                                       int64_t batch, int64_t slots, int64_t groups) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= batch * groups * kSums) return;
  const int64_t k = i % kSums;
  const int64_t g = (i / kSums) % groups;
  const int64_t b = i / (kSums * groups);
  const int64_t lo = g * kReduceGroup;
  const int64_t hi = lo + kReduceGroup < slots ? lo + kReduceGroup : slots;
  const T* src = in + b * slots * kSums + k;
  T acc = src[lo * kSums];
  for (int64_t s = lo + 1; s < hi; ++s) acc = acc + src[s * kSums];
  out[i] = acc;
}

// Sums the (batch, slots, 36) partials of each setting into out (batch,
// 36).  The levels alternate between scratch, (batch, ceil(slots /
// kReduceGroup), 36), and the partial buffer itself; the last writes out.
template <typename T>
void reduce_partials(T* partials, T* scratch, T* out, int64_t batch, int64_t slots,
                     cudaStream_t stream) {
  T* src = partials;
  T* dst = scratch;
  while (true) {
    const int64_t groups = (slots + kReduceGroup - 1) / kReduceGroup;
    T* target = groups == 1 ? out : dst;
    const int64_t threads = batch * groups * kSums;
    const int64_t blocks = (threads + kReduceThreads - 1) / kReduceThreads;
    reduce_partials_kernel<T><<<static_cast<unsigned>(blocks), kReduceThreads, 0, stream>>>(
        src, target, batch, slots, groups);
    if (groups == 1) return;
    slots = groups;
    T* next = src;
    src = dst;
    dst = next;
  }
}

}  // namespace lynx
