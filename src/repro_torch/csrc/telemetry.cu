// Device probes of the replay's telemetry (src/repro_torch/_telemetry.py).
//
// One thread reads the card's %globaltimer (nanoseconds, one clock for
// every SM) and updates a small int64 record in device memory, so a
// stage's device time is taken where the stream runs it, with no host
// read and no event.  The stream is one chain of kernels, so the time
// between two probes is the device time of the kernels enqueued between
// them as the stream experiences it (their idle gaps inside included).
//
// Record layout (int64): [0] last probe's time, [1] last close's time,
// [2] gap, [3] device spans opened, [4, 4 + K) each stage's summed
// nanoseconds, [4 + K, 4 + 2K) each stage's marks.  Operations:
//
//   open      gap += t - rec[1] when a span was opened before; last = t
//   mark(k)   sum[k] += t - last; cnt[k] += 1; last = t
//   close(k)  mark(k), then rec[1] = t
//
// `gap` is then the time the device sat between the replay's own device
// spans: its idle time, measured without a profiler.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<int64_t>(t);
}

__global__ void probe_kernel(int64_t* rec, int op, int k, int n_stages) {
  const int64_t t = global_ns();
  if (op == 0) {
    if (rec[3] > 0) rec[2] += t - rec[1];
    rec[3] += 1;
    rec[0] = t;
    return;
  }
  rec[4 + k] += t - rec[0];
  rec[4 + n_stages + k] += 1;
  rec[0] = t;
  if (op == 2) rec[1] = t;
}

}  // namespace

// op: 0 open, 1 mark, 2 close; k: the stage (ignored by open)
extern "C" int fenix_probe_launch(int64_t* rec, int op, int k, int n_stages,
                                  cudaStream_t stream) {
  probe_kernel<<<1, 1, 0, stream>>>(rec, op, k, n_stages);
  return static_cast<int>(cudaGetLastError());
}
