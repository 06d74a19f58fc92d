// Span stamps for CUDA graphs (lynx_tpu_torch/profiling.py).
//
// A span entered while a graph is captured with tracing on launches this
// one-thread kernel at its enter and at its exit.  It writes the device's
// %globaltimer (nanoseconds) into a ring of (rows, slots) stamps: the slot
// is the stamp's place in the graph, fixed at capture, and the row is the
// graph's replay counter, held on the device, modulo rows.  The graph's last
// stamp (the exit of its root span) advances the counter, so that each
// replay writes a row of its own even where several replays are queued at
// once.  A CUDA event recorded inside a graph cannot do this: each replay
// records the same event again.
//
// Stream order places a stamp after every operation captured before it and
// before every operation captured after it: one stamp kernel costs about a
// node's launch on the device, a few microseconds.

#include <cuda_runtime.h>

#include <cstdint>

#ifdef LYNX_HOST_STAND_IN
#include <chrono>
#endif

namespace {

#ifndef LYNX_HOST_STAND_IN
__device__ __forceinline__ unsigned long long lynx_globaltimer() {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  return now;
}
#else
inline unsigned long long lynx_globaltimer() {
  return static_cast<unsigned long long>(std::chrono::duration_cast<std::chrono::nanoseconds>(
      std::chrono::steady_clock::now().time_since_epoch()).count());
}
#endif

__global__ void span_stamp_kernel(long long* ring, long long* counter, int slot, int slots,
                                  int rows, int advance) {
  const long long replay = *reinterpret_cast<volatile long long*>(counter);
  ring[(replay % rows) * slots + slot] = static_cast<long long>(lynx_globaltimer());
  if (advance) {
    *counter = replay + 1;
  }
}

// The smallest step of the timer over `changes` changes, read by one thread
// spinning on it.
__global__ void timer_resolution_kernel(long long* out, int changes) {
  unsigned long long last = lynx_globaltimer();
  unsigned long long least = ~0ull;
  for (int seen = 0; seen < changes;) {
    const unsigned long long now = lynx_globaltimer();
    if (now != last) {
      if (now - last < least) least = now - last;
      last = now;
      ++seen;
    }
  }
  *out = static_cast<long long>(least);
}

}  // namespace

extern "C" {

// ring: (rows, slots) int64; counter: one int64, the replays whose last
// stamp has run.  Writes ring[counter % rows][slot]; advance != 0 then adds
// one to the counter.  Returns cudaGetLastError().
int lynx_span_stamp(void* ring, void* counter, int slot, int slots, int rows, int advance,
                    void* stream) {
  span_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(counter), slot, slots, rows,
      advance);
  return static_cast<int>(cudaGetLastError());
}

// out: one int64, the timer's smallest step in nanoseconds.
int lynx_span_timer_resolution(void* out, int changes, void* stream) {
  timer_resolution_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), changes);
  return static_cast<int>(cudaGetLastError());
}

const char* lynx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
