// Particle moment sweep, the packed-Gram route (kernel B6), for Hopper,
// sm_90a.
//
// Replaces the TPU kernel lynx_tpu/ops/pallas_track.py:_packed_gram_kernel
// (launched by _moment_sweep_packed_impl).  The final coordinates of a
// particle are an affine image T x of its incoming ones, so the moments after
// the plan are T (sum_n W_n x x^T) T^T: only the survival weights W depend
// on the setting through the apertures.  For each setting b and particle n
// the kernel forms each aperture's plane position as the sparse dot of the
// setting's prefix-map row with the augmented particle aug = [x_0..x_6,
// valid] (the plane centre rides on valid), multiplies W = w0 * prod of the
// masks, and sums the 36 distinct products W aug_j aug_k (j <= k < 8) of the
// joint Gram.  The 7x7 sandwich with T runs in PyTorch afterwards, as the
// JAX package runs it outside its kernel.
//
// What bounds it on an H100: arithmetic.  Per (setting, particle): a few
// FMAs per plane row, the mask compares and 72 flops for the Gram, against
// 36 bytes of the cloud that every setting re-reads from L2 (3.6 MB in f32
// at N = 100,000).  At B = 256 that is ~2e9 flops, ~30 us at the card's
// 67 TFLOP/s of FP32 outside the tensor cores.  The TPU ran the Gram as a
// product on its matrix unit at default precision; here it is plain FP32
// (or FP64) FMAs, never a library GEMM, so the port holds it against an
// exact plain version.
//
// Design, simple first, the same two stages as kernel B5: one thread per
// (setting, particle slot) sums in registers into a (B, slots, 36) partial
// buffer; moment_sums.cuh sums the partials per setting in a fixed order.
// A ragged B and N are bounds checks; nothing is padded.

#include <cuda_runtime.h>

#include <cstdint>

#include "moment_sums.cuh"

namespace {

// Aperture records; lynx_tpu_torch/ops/fused_track.py has the same layout:
// shape (0 rectangular), first x plane row, x row count, first y plane row,
// y row count, 3 unused.
constexpr int kRecord = 8;
constexpr int kThreads = 128;

// v[j] for a j known only at run time, by selects: the array stays in
// registers.
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[8], int j) {
  T out = v[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) out = j == k ? v[k] : out;
  return out;
}

// Plane position: sum over the aperture's plane rows r of planes[r, b] *
// aug[row_index[r]], in row order.
template <typename T>
__device__ __forceinline__ T plane(const T (&a)[8], const T* __restrict__ planes,
                                   const int* __restrict__ row_index, int start, int count,
                                   int64_t batch, int64_t b) {
  T acc = planes[start * batch + b] * pick(a, row_index[start]);
  for (int r = start + 1; r < start + count; ++r) {
    acc = acc + planes[r * batch + b] * pick(a, row_index[r]);
  }
  return acc;
}

template <typename T>
__global__ void packed_gram_kernel(const int* __restrict__ apertures, int n_apertures,
                                   const int* __restrict__ row_index, const T* __restrict__ planes,
                                   const T* __restrict__ bounds, const T* __restrict__ aug,
                                   const T* __restrict__ w0, T* __restrict__ partials,
                                   int64_t batch, int64_t n, int64_t slots) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= batch * slots) return;
  const lynx::Slot at = lynx::slot_of(i, slots);
  const int64_t b = at.setting;

  T acc[lynx::kSums];
#pragma unroll
  for (int k = 0; k < lynx::kSums; ++k) acc[k] = T(0);

  for (int64_t p = at.slot; p < n; p += slots) {
    T a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = aug[j * n + p];
    T W = w0[p];

    for (int ap = 0; ap < n_apertures; ++ap) {
      const int* rec = apertures + ap * kRecord;
      // bounds: (n_apertures, 4, batch), [x_max, y_max, 1/x_max^2, 1/y_max^2].
      const T* bound = bounds + static_cast<int64_t>(ap) * 4 * batch + b;
      const T px = plane(a, planes, row_index, rec[1], rec[2], batch, b);
      if (rec[0] == 0) {
        const T x_max = bound[0];
        W = W * ((px > -x_max && px < x_max) ? T(1) : T(0));
        const T py = plane(a, planes, row_index, rec[3], rec[4], batch, b);
        const T y_max = bound[batch];
        W = W * ((py > -y_max && py < y_max) ? T(1) : T(0));
      } else {
        // The reciprocal form of the TPU kernel: px^2 / x_max^2 as px^2 * (1 / x_max^2).
        const T t = px * px * bound[2 * batch];
        const T py = plane(a, planes, row_index, rec[3], rec[4], batch, b);
        W = W * ((t + py * py * bound[3 * batch] <= T(1)) ? T(1) : T(0));
      }
    }

    int k = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int m = j; m < 8; ++m) {
        acc[k] = acc[k] + W * (a[j] * a[m]);
        ++k;
      }
    }
  }

  T* out = partials + i * lynx::kSums;
#pragma unroll
  for (int k = 0; k < lynx::kSums; ++k) out[k] = acc[k];
}

template <typename T>
void launch(const void* apertures, int n_apertures, const void* row_index, const void* planes,
            const void* bounds, const void* aug, const void* w0, void* partials, void* scratch,
            void* out, long long batch, long long n, long long slots, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(batch) * slots;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  packed_gram_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int*>(apertures), n_apertures, static_cast<const int*>(row_index),
      static_cast<const T*>(planes), static_cast<const T*>(bounds), static_cast<const T*>(aug),
      static_cast<const T*>(w0), static_cast<T*>(partials), batch, n, slots);
  lynx::reduce_partials<T>(static_cast<T*>(partials), static_cast<T*>(scratch),
                           static_cast<T*>(out), batch, slots, stream);
}

}  // namespace

extern "C" {

// apertures: (n_apertures, 8) int32 records; row_index: (R,) int32, the aug
// row of each plane row; planes: (R, batch); bounds: (n_apertures, 4, batch);
// aug: (8, n); w0: (n,); partials: (batch, slots, 36) and scratch: (batch,
// ceil(slots / 64), 36) workspace; out: (batch, 36), the Gram's upper
// triangle (j <= k, row-major).  All float (is_double = 0) or double
// (is_double = 1), contiguous.  Returns cudaGetLastError().
int lynx_packed_gram(int is_double, const void* apertures, int n_apertures, const void* row_index,
                     const void* planes, const void* bounds, const void* aug, const void* w0,
                     void* partials, void* scratch, void* out, long long batch, long long n,
                     long long slots, void* stream) {
  if (batch > 0 && slots > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (is_double) {
      launch<double>(apertures, n_apertures, row_index, planes, bounds, aug, w0, partials,
                     scratch, out, batch, n, slots, s);
    } else {
      launch<float>(apertures, n_apertures, row_index, planes, bounds, aug, w0, partials,
                    scratch, out, batch, n, slots, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
