// Device stage mark: the stamp of utils/profiling.mark.
//
// Replaces no TPU kernel: the JAX package times its stages with
// jax.profiler's named scopes, which the compiler keeps inside one program.
// A CUDA graph replay has no host-side ranges inside it, so the port stamps
// its stages from the device: one thread reads %globaltimer (ns) and writes
// it, with the stage's id, into a ring in device memory at a device cursor.
// Launched inside a stream capture, the launch becomes a node of the graph
// and every replay stamps its stages without host work.
//
// What bounds it: nothing of the kernel itself (one atomic and two 8-byte
// stores); a mark costs one kernel node's launch on the stream, ~2 us, and
// orders the stream as every kernel does, so a stage lasts from its mark
// to the next one.
//
// ring: int64 [1 + 2 * cap]: ring[0] the count of marks ever written, then
// (ns, stage) pairs; mark k goes to pair k % cap.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" __global__ void stage_mark(unsigned long long* ring, int cap, int stage) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long k = atomicAdd(ring, 1ULL) % static_cast<unsigned long long>(cap);
  ring[1 + 2 * k] = t;
  ring[2 + 2 * k] = static_cast<unsigned long long>(stage);
}

// Loads the kernel (lazy module loading would otherwise load it at its first
// launch, which may fall inside a capture). Returns a cudaError_t.
extern "C" int stage_mark_load() {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, stage_mark));
}

// One mark on `stream`; returns the launch's cudaError_t.
extern "C" int stage_mark_launch(unsigned long long* ring, int cap, int stage,
                                 cudaStream_t stream) {
  stage_mark<<<1, 1, 0, stream>>>(ring, cap, stage);
  return static_cast<int>(cudaGetLastError());
}
