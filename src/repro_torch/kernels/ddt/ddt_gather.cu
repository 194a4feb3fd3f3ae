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
// What bounds it on the H100.  Bytes moved: 4 bytes of index and one
// element out per output, plus the source elements the map touches.  At
// the ingest's size (a 128 KiB message, about 33k elements) that is a few
// hundred KB, about a tenth of a microsecond at 3.35 TB/s, so one launch's
// latency dominates: the ingest composes its two maps (message -> buffer,
// buffer -> tokens) into one at construction and runs one gather per call,
// with no application buffer in device memory.  At MiB sizes it is bound by
// the bytes, and the design cuts the number of memory requests.
//
// Design.  A committed datatype's map is piecewise contiguous, so the
// vector body gives each thread a group of G = 16 / sizeof(T) consecutive
// outputs (four int32s): its G indices in 16-byte loads (one for 4-byte
// elements, four for 1-byte ones; one 8-byte load for 8-byte ones), one
// 16-byte load from the source when the group's indices are one run j,
// j+1, ... that lies inside the source and starts 16-byte aligned, else
// one __ldg per element, and one 16-byte store.  Loads and stores of
// neighbouring threads are neighbouring 16-byte pieces, so a warp moves
// whole lines.
// The last, ragged group is done element by element by its thread.  When
// idx or out is not 16-byte aligned (a view at an offset), the scalar body
// runs instead: one thread per output, 4-byte index loads, coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T gather_one(const T* __restrict__ src, int64_t s,
                                        int32_t j, T fill) {
  if (j < 0) return fill;
  return __ldg(src + (j < s ? static_cast<int64_t>(j) : s - 1));
}

template <typename T>
__global__ void gather_kernel(const T* __restrict__ src, int64_t s,
                              const int32_t* __restrict__ idx, int64_t n,
                              T* __restrict__ out, T fill) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  out[i] = gather_one(src, s, idx[i], fill);
}

template <typename T>
__global__ void gather_vec_kernel(const T* __restrict__ src, int64_t s,
                                  const int32_t* __restrict__ idx, int64_t n,
                                  T* __restrict__ out, T fill) {
  constexpr int G = 16 / sizeof(T);          // outputs per thread
  union Group { uint4 u; T v[G]; };
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x) * G;
  if (i0 >= n) return;
  if (i0 + G > n) {                          // the ragged tail
    for (int64_t i = i0; i < n; ++i) out[i] = gather_one(src, s, idx[i], fill);
    return;
  }
  int32_t j[G];
  if constexpr (G >= 4) {
#pragma unroll
    for (int q = 0; q < G / 4; ++q) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(idx + i0) + q);
      j[4 * q] = t.x; j[4 * q + 1] = t.y; j[4 * q + 2] = t.z;
      j[4 * q + 3] = t.w;
    }
  } else {
    const int2 t = __ldg(reinterpret_cast<const int2*>(idx + i0));
    j[0] = t.x; j[1] = t.y;
  }
  bool run = j[0] >= 0 && static_cast<int64_t>(j[0]) + G <= s &&
             reinterpret_cast<uintptr_t>(src + j[0]) % 16 == 0;
#pragma unroll
  for (int k = 1; k < G; ++k)
    run = run && static_cast<int64_t>(j[k]) == static_cast<int64_t>(j[0]) + k;
  Group g;
  if (run) {
    g.u = __ldg(reinterpret_cast<const uint4*>(src + j[0]));
  } else {
#pragma unroll
    for (int k = 0; k < G; ++k) g.v[k] = gather_one(src, s, j[k], fill);
  }
  *reinterpret_cast<uint4*>(out + i0) = g.u;
}

template <typename T>
int launch(const void* src, int64_t s, const void* idx, int64_t n, void* out,
           uint64_t fill_bits, cudaStream_t stream) {
  const int threads = 256;
  const T* sp = static_cast<const T*>(src);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  T* op = static_cast<T*>(out);
  const T fill = static_cast<T>(fill_bits);
  if ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out))
      % 16 == 0) {
    constexpr int64_t g = 16 / sizeof(T);
    const int64_t groups = (n + g - 1) / g;
    gather_vec_kernel<T><<<static_cast<unsigned>((groups + threads - 1) /
                                                 threads),
                           threads, 0, stream>>>(sp, s, ip, n, op, fill);
  } else {
    gather_kernel<T><<<static_cast<unsigned>((n + threads - 1) / threads),
                       threads, 0, stream>>>(sp, s, ip, n, op, fill);
  }
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
