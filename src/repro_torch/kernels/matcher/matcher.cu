// K1: the FPsPIN U32 matching engine (paper §IV, block 1) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/matcher/matcher.py,
// match_pallas (body _matcher_kernel), and computes what its plain
// reference match_ref computes:
//   for packet n and context c, rule r = (idx, mask, start, end) selects the
//   big-endian u32 word at byte 4*idx of the frame (idx read as int32 and
//   clipped to [0, W-1]) and tests start <= (word & mask) <= end, unsigned;
//   matched[n, c] is the AND (mode 0) or OR (any other mode) of rules 0-2,
//   eom[n, c] is rule 3.
//
// Design.  One thread per (packet, context).  The C x 4 x 4 rule table and
// the modes are staged in shared memory once per block.  The kernel reads
// the uint8 frames (N, row_bytes) directly and assembles each word from the
// four bytes at 4*idx itself (one aligned 32-bit load and a byte
// permute), so the caller never builds an (N, W) word tensor: a rule needs
// 4 bytes of a 1536-byte frame.  Arithmetic is uint32 throughout.
//
// What bounds it on the H100.  The function must read only the distinct
// words its rules select (about 20 bytes of each frame for the built-in
// rulesets) and write 2*N*C bytes, so it is bound by bytes moved.  At the
// main path's N = 64 frames that is a few KB, far below one launch's
// latency (several microseconds): the kernel is bound by launch latency,
// and the design keeps it to one launch per batch with no word tensor or
// other pre-pass.  At large N the row reads are 4-byte loads strided by
// the frame size, so each touches its own 32-byte sector; a later change
// could have a warp share one frame's selected sectors.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void match_kernel(const uint8_t* __restrict__ data, int64_t n,
                             int64_t row_bytes,
                             const int64_t* __restrict__ rules,
                             const int32_t* __restrict__ modes, int n_ctx,
                             uint8_t* __restrict__ matched,
                             uint8_t* __restrict__ eom) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_rules = smem;                       // n_ctx * 16
  int32_t* s_modes = reinterpret_cast<int32_t*>(smem + n_ctx * 16);
  for (int i = threadIdx.x; i < n_ctx * 16; i += blockDim.x)
    s_rules[i] = static_cast<uint32_t>(static_cast<uint64_t>(rules[i]));
  for (int i = threadIdx.x; i < n_ctx; i += blockDim.x)
    s_modes[i] = modes[i];
  __syncthreads();

  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= n * n_ctx) return;
  const int64_t p = t / n_ctx;
  const int c = static_cast<int>(t - p * n_ctx);
  const int32_t w_max = static_cast<int32_t>(row_bytes / 4) - 1;
  const uint8_t* row = data + p * row_bytes;

  bool ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t* rule = s_rules + (c * 4 + r) * 4;
    int32_t idx = static_cast<int32_t>(rule[0]);
    idx = idx < 0 ? 0 : (idx > w_max ? w_max : idx);
    const uint32_t raw =
        *reinterpret_cast<const uint32_t*>(row + 4 * static_cast<int64_t>(idx));
    const uint32_t word = __byte_perm(raw, 0, 0x0123);   // big-endian
    const uint32_t v = word & rule[1];
    ok[r] = (v >= rule[2]) && (v <= rule[3]);
  }
  const bool m = (s_modes[c] == 0) ? (ok[0] && ok[1] && ok[2])
                                   : (ok[0] || ok[1] || ok[2]);
  matched[t] = m ? 1 : 0;
  eom[t] = ok[3] ? 1 : 0;
}

}  // namespace

extern "C" int repro_match(const void* data, int64_t n, int64_t row_bytes,
                           const void* rules, const void* modes, int n_ctx,
                           void* matched, void* eom, void* stream) {
  const int64_t total = n * n_ctx;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) /
                                                threads);
  const size_t smem = static_cast<size_t>(n_ctx) * (16 + 1) * 4;
  match_kernel<<<blocks, threads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, row_bytes,
      static_cast<const int64_t*>(rules), static_cast<const int32_t*>(modes),
      n_ctx, static_cast<uint8_t*>(matched), static_cast<uint8_t*>(eom));
  return static_cast<int>(cudaGetLastError());
}
