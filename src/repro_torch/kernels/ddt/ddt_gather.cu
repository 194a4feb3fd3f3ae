// K2: the committed-datatype gather behind MPI DDT pack and unpack
// (paper §V-C, Fig 10) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ddt/ddt.py, ddt_gather_pallas
// (body _gather_kernel), and computes what its plain reference
// ddt_gather_ref computes:
//   out[i] = idx[i] < 0 ? fill : src[min(idx[i], S - 1)].
// The TPU kernel is a masked compare-and-sum over source blocks, because
// the TPU's vector unit has no dynamic gather; that form turns -0.0 into
// +0.0 and gives 0 for idx >= S.  Hopper gathers directly, so this kernel
// moves bit patterns: it is templated on the element size (1, 2, 4 or 8
// bytes) and never interprets the values, which makes it exact for every
// dtype (-0.0 and NaN payloads included).  ``fill`` arrives as the bit
// pattern of the fill value in the source dtype.
//
// Design.  One thread per output element: the reads of idx and the writes
// of out are coalesced; the reads of src follow the index map and go
// through L2 (a committed datatype's map is piecewise contiguous, so
// neighbouring threads mostly hit neighbouring source elements).
//
// What bounds it on the H100.  Bytes moved: 4 bytes of index and one
// element out per output, plus the source elements the map touches.  At
// the main path's sizes (a 128 KiB message, about 33k elements) that is a
// few hundred KB, under a microsecond at 3.35 TB/s, so one launch's
// latency dominates; the design keeps the gather to one launch with no
// padding or pre-pass.  At MiB sizes the kernel streams at a large share
// of the memory rate because idx/out are coalesced and src reads of a
// contiguous run share sectors.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void gather_kernel(const T* __restrict__ src, int64_t s,
                              const int32_t* __restrict__ idx, int64_t n,
                              T* __restrict__ out, T fill) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int32_t j = idx[i];
  if (j < 0) {
    out[i] = fill;
  } else {
    const int64_t k = j < s ? static_cast<int64_t>(j) : s - 1;
    out[i] = __ldg(src + k);
  }
}

template <typename T>
int launch(const void* src, int64_t s, const void* idx, int64_t n, void* out,
           uint64_t fill_bits, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  gather_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(src), s, static_cast<const int32_t*>(idx), n,
      static_cast<T*>(out), static_cast<T>(fill_bits));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError of the launch; -1 for an element size the kernel
// does not take.
extern "C" int repro_ddt_gather(const void* src, int64_t s, const void* idx,
                                int64_t n, void* out, int elem_bytes,
                                uint64_t fill_bits, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(src, s, idx, n, out, fill_bits, st);
    case 2: return launch<uint16_t>(src, s, idx, n, out, fill_bits, st);
    case 4: return launch<uint32_t>(src, s, idx, n, out, fill_bits, st);
    case 8:
      return launch<unsigned long long>(src, s, idx, n, out, fill_bits, st);
    default: return -1;
  }
}
