// K3: batched RFC1071 internet checksum for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/checksum/checksum.py,
// checksum_pallas (body _checksum_kernel), and computes what its plain
// reference checksum_ref computes, bit for bit: per packet, the sum in
// 32 bits of the big-endian 16-bit words with word index in
// [start / 2, (length + 1) / 2), clipped to width / 2, two end-around-carry
// folds, and ~sum & 0xFFFF.  (length + 1) is taken in int32 as the
// reference takes it: a negative length, and a length of 2**31 - 1 (where
// it wraps), has no live word.  For an odd length the last word pairs the
// final byte with the byte that follows it in the buffer, whatever that
// byte is, as the reference reads it.
//
// Design.  One warp per packet, eight packets per block.  The lanes read
// the packet's live 16-byte chunks (a chunk is 8 words; ref.live_byte_ranges
// gives the bytes they cover) with vector loads, neighbouring lanes on
// neighbouring chunks, add the live words of each chunk, and reduce across
// the warp with shuffles; lane 0 folds and writes.  Chunks outside the live
// word range are never read, so a short packet costs a few sectors, not its
// whole 1,536-byte row.  The TPU kernel pads N to its 128-row tile; here a
// block's tail warps simply return.
//
// What bounds it on the H100: bytes.  Each packet's live bytes are read
// once, its length read and its checksum written once; there are about 3
// integer operations per byte, far below the card's integer rate.  On
// large batches it stays below that bound: every load waits for the
// packet's length, and a lane's chunks (up to 3 at 1,536 bytes) are loaded
// one after another, so a warp has at most 512 bytes in flight and none
// while it waits for its length.  The system's callers send 64 frames a
// call, all in L2, where the cost is the launch and two dependent round
// trips (length, then data); a body that keeps more bytes in flight
// (a persistent grid streaming the live ranges into shared memory) pays
// for itself only on batches of thousands of frames, which no caller sends.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ uint32_t add_live(uint32_t u, int w0, int w_lo,
                                             int w_hi) {
  // u holds bytes 4j .. 4j+3 of the row (little-endian load): two words
  const uint32_t first = ((u & 0xFFu) << 8) | ((u >> 8) & 0xFFu);
  const uint32_t second = ((u >> 8) & 0xFF00u) | (u >> 24);
  uint32_t s = 0;
  if (w0 >= w_lo && w0 < w_hi) s += first;
  if (w0 + 1 >= w_lo && w0 + 1 < w_hi) s += second;
  return s;
}

__global__ void __launch_bounds__(WARPS * 32)
    checksum_kernel(const uint8_t* __restrict__ data,
                    const int32_t* __restrict__ lengths, int64_t n, int width,
                    int start, int64_t* __restrict__ out) {
  const int64_t pkt = static_cast<int64_t>(blockIdx.x) * WARPS +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pkt >= n) return;
  const int w_lo = start / 2;
  const int len = lengths[pkt];
  // (len + 1) / 2 with the int32 wrap of the reference, without overflow
  const int w_hi = len >= 0 && len < INT_MAX
                       ? min(len / 2 + (len & 1), width / 2) : 0;
  const uint4* row = reinterpret_cast<const uint4*>(data + pkt * width);
  uint32_t sum = 0;
  for (int c = w_lo / 8 + lane; c < (w_hi + 7) / 8; c += 32) {
    const uint4 x = __ldg(row + c);
    const int w0 = c * 8;
    sum += add_live(x.x, w0, w_lo, w_hi) + add_live(x.y, w0 + 2, w_lo, w_hi) +
           add_live(x.z, w0 + 4, w_lo, w_hi) + add_live(x.w, w0 + 6, w_lo, w_hi);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    sum = (sum & 0xFFFFu) + (sum >> 16);
    sum = (sum & 0xFFFFu) + (sum >> 16);
    out[pkt] = static_cast<int64_t>(~sum & 0xFFFFu);
  }
}

}  // namespace

// data (N, width) uint8 with width % 16 == 0 and 16-byte aligned rows;
// lengths (N,) int32; out (N,) int64.  Returns the cudaError of the launch,
// or -1 for arguments the kernel does not take.
extern "C" int repro_checksum(const void* data, const void* lengths,
                              int64_t n, int width, int start, void* out,
                              void* stream) {
  if (width % 16 || start < 0) return -1;
  if (n == 0) return 0;
  const int64_t blocks = (n + WARPS - 1) / WARPS;
  if (blocks > 0x7FFFFFFF) return -1;
  checksum_kernel<<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      n, width, start, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
