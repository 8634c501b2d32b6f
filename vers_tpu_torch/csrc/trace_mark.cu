// Stage markers of the port's trace (vers_tpu_torch/trace.py).
//
// A search's device work is replayed from a CUDA graph, where no Python
// runs, so host spans cannot say which stage of it owns the device's
// time. A marker is a kernel of one thread that does nothing and whose
// name carries its stage: vers::trace::mark<S>, S the stage's index in
// trace.STAGES. Launched on the search's stream it lies between the
// stages in the device's record, and launched inside a capture it is a
// node of the graph, so every replay records it too. A profiler's
// device records between one marker and the next are that stage's work.

#include <cuda_runtime.h>

namespace vers {
namespace trace {

template <int S>
__global__ void mark() {}

}  // namespace trace
}  // namespace vers

// One marker of stage `stage` (0 <= stage < 13: the binned search's five,
// then the HNSW search's four, then the forest search's four) on `stream`.
extern "C" int vers_trace_mark(int stage, void* stream) {
  namespace tr = vers::trace;
  cudaStream_t st = (cudaStream_t)stream;
  switch (stage) {
    case 0: tr::mark<0><<<1, 1, 0, st>>>(); break;
    case 1: tr::mark<1><<<1, 1, 0, st>>>(); break;
    case 2: tr::mark<2><<<1, 1, 0, st>>>(); break;
    case 3: tr::mark<3><<<1, 1, 0, st>>>(); break;
    case 4: tr::mark<4><<<1, 1, 0, st>>>(); break;
    case 5: tr::mark<5><<<1, 1, 0, st>>>(); break;
    case 6: tr::mark<6><<<1, 1, 0, st>>>(); break;
    case 7: tr::mark<7><<<1, 1, 0, st>>>(); break;
    case 8: tr::mark<8><<<1, 1, 0, st>>>(); break;
    case 9: tr::mark<9><<<1, 1, 0, st>>>(); break;
    case 10: tr::mark<10><<<1, 1, 0, st>>>(); break;
    case 11: tr::mark<11><<<1, 1, 0, st>>>(); break;
    case 12: tr::mark<12><<<1, 1, 0, st>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
