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
// Two forms, one library:
//   repro_match        the (N, C) form above, one thread per (packet,
//                      context); what match_pallas computes.
//   repro_match_first  the whole matching stage of repro.core.matching.
//                      match_batch: ctx_id[n] = the lowest-numbered context
//                      whose rules match (-1 if none, or the lane is not
//                      valid) and eom[n] = that context's EOM rule.  This is
//                      the form the NIC step and the ingest run: before it,
//                      the stage was the (N, C) kernel plus seven PyTorch
//                      ops (mask by valid, any, cast, argmax, where, gather,
//                      and), each its own launch.
//
// What bounds it on the H100.  The function must read, per frame, only the
// words its rules select and write 5 bytes (ctx_id, eom): bound by bytes
// moved.  Counted as words, that is 20 bytes a frame for the built-in
// ICMP/UDP/SLMP tables (words 3, 5, 8, 9, 10); but memory moves 32-byte
// sectors, and those words lie in two of them (bytes 0-63), so the least
// the card can move is 64 bytes a frame: that is the bound the design aims
// at.  At the NIC's N = 64 either count is a few KB, far below one
// launch's latency, so there the kernel is bound by latency: the launch,
// the dependent memory round trips inside it, and the fetch of its own
// code.  (A first version that built the list of distinct selected words
// per block, with two more barriers, and picked each rule's word out of
// registers by a select over that list took 6.1 us at N = 64 on an H100,
// twice the (N, C) kernel: its code was many times larger.)
//
// Design of repro_match_first.  One thread per frame, 128 frames a block,
// one barrier.  Before it, three things go out at once: each warp loads the
// 64-byte heads of its 32 frames into shared memory (lanes 4 to a frame,
// 16 bytes each, so a warp's load covers whole sectors and each sector is
// read once), the block stages the rule table (u32 fields, idx clipped),
// and each thread reads its lane's valid bit.  After it, a thread
// evaluates the contexts in priority order, stops at the first match and
// evaluates that context's EOM rule only; a rule's word comes from the
// staged head by one shared-memory load (words 0-15, where the built-in
// rules' fields lie: Ethernet, IP and the UDP ports, SLMP flags), or from
// memory through L1 for a word further in.  So every selected word of the
// head is loaded from memory once, whatever the number of contexts that
// read it.  Every load of the first half is issued before any store to
// shared memory, so the half costs one memory round trip: written in the
// order head, table, valid, with each load's stores after it, the loads
// went out one after another, and the kernel took 0.5 us more than the
// (N, C) kernel at N = 64 on an H100 where it now takes 0.14 us more.  A
// frame whose base or row size is not 16-byte aligned (or a row under 64
// bytes) reads every word from memory.
//
// Design of repro_match (unchanged since it was first ported): one thread
// per (packet, context) reads each of its four words with its own 4-byte
// load strided by the frame size, so at large N each touches its own
// sector, and contexts that select the same word load it again.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 128;      // frames (threads) per block, first form
constexpr int kHeadWords = 16;    // words of a frame's head staged (64 B)
constexpr int kHeadStride = kFrames + 1;   // [word][frame], padded

struct alignas(16) Rule {         // one rule, staged in shared memory
  uint32_t mask, start, end;
  int32_t idx;                    // clipped word index
};

// Whether the frame of this thread passes rule r: a word of the head comes
// from shared memory, any other from memory (L1).
template <bool kHead>
__device__ __forceinline__ bool rule_ok(const Rule& r, const uint32_t* s_head,
                                        const uint8_t* row) {
  const uint32_t word =
      kHead && r.idx < kHeadWords
          ? s_head[r.idx * kHeadStride + threadIdx.x]
          : __byte_perm(__ldg(reinterpret_cast<const uint32_t*>(row) + r.idx),
                        0, 0x0123);
  const uint32_t v = word & r.mask;
  return v >= r.start && v <= r.end;
}

template <bool kHead>
__global__ void __launch_bounds__(kFrames)
match_first_kernel(const uint8_t* __restrict__ data, int64_t n,
                   int64_t row_bytes, const int64_t* __restrict__ rules,
                   const int32_t* __restrict__ modes, int n_ctx,
                   const uint8_t* __restrict__ valid,
                   int32_t* __restrict__ ctx_out,
                   uint8_t* __restrict__ eom_out) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_head = smem;                  // kHeadWords x kHeadStride
  Rule* s_rule = reinterpret_cast<Rule*>(
      smem + (kHead ? kHeadWords * kHeadStride + 3 : 0) / 4 * 4);
  int32_t* s_mode = reinterpret_cast<int32_t*>(s_rule + 4 * n_ctx);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kFrames;
  const int64_t p = base + threadIdx.x;
  const int n_rules = 4 * n_ctx;
  const int32_t w_max = static_cast<int32_t>(row_bytes / 4) - 1;

  // Every load first, so that all are in flight at once: the heads of the
  // warp's 32 frames (a step covers 8 frames, 4 lanes to a frame, 16 bytes
  // a lane, so a warp's load covers whole sectors), this thread's rule and
  // mode, and its lane's valid bit.  Then the stores to shared memory.
  const int lane = threadIdx.x & 31, chunk = lane & 3;
  uint4 q[4] = {};
  if (kHead) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t f = base + (threadIdx.x & ~31) + 8 * j + (lane >> 2);
      if (f < n)
        q[j] = __ldg(reinterpret_cast<const uint4*>(data + f * row_bytes) +
                     chunk);
    }
  }
  int64_t rule[4] = {0, 0, 0, 0};
  if (threadIdx.x < n_rules) {
#pragma unroll
    for (int k = 0; k < 4; ++k) rule[k] = rules[4 * threadIdx.x + k];
  }
  const int32_t mode = threadIdx.x < n_ctx ? modes[threadIdx.x] : 0;
  const bool live = p < n && valid[p];

  if (kHead) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = (threadIdx.x & ~31) + 8 * j + (lane >> 2);
      if (base + f < n) {
        uint32_t* col = s_head + 4 * chunk * kHeadStride + f;
        col[0] = __byte_perm(q[j].x, 0, 0x0123);
        col[kHeadStride] = __byte_perm(q[j].y, 0, 0x0123);
        col[2 * kHeadStride] = __byte_perm(q[j].z, 0, 0x0123);
        col[3 * kHeadStride] = __byte_perm(q[j].w, 0, 0x0123);
      }
    }
  }
  // rules past the first kFrames (more than 32 contexts) are staged in turn
  for (int i = threadIdx.x; i < n_rules; i += kFrames) {
    if (i != threadIdx.x) {
#pragma unroll
      for (int k = 0; k < 4; ++k) rule[k] = rules[4 * i + k];
    }
    int32_t idx = static_cast<int32_t>(static_cast<uint32_t>(rule[0]));
    idx = idx < 0 ? 0 : (idx > w_max ? w_max : idx);
    s_rule[i] = {static_cast<uint32_t>(rule[1]),
                 static_cast<uint32_t>(rule[2]),
                 static_cast<uint32_t>(rule[3]), idx};
  }
  if (threadIdx.x < n_ctx) s_mode[threadIdx.x] = mode;
  for (int i = threadIdx.x + kFrames; i < n_ctx; i += kFrames)
    s_mode[i] = modes[i];
  __syncthreads();

  if (p >= n) return;
  const uint8_t* row = data + p * row_bytes;
  int32_t ctx = -1;
  bool eom = false;
  if (live) {
    for (int c = 0; c < n_ctx; ++c) {
      const Rule* r = s_rule + 4 * c;
      const bool a = rule_ok<kHead>(r[0], s_head, row),
                 b = rule_ok<kHead>(r[1], s_head, row),
                 d = rule_ok<kHead>(r[2], s_head, row);
      if (s_mode[c] == 0 ? (a && b && d) : (a || b || d)) {
        ctx = c;
        eom = rule_ok<kHead>(r[3], s_head, row);
        break;
      }
    }
  }
  ctx_out[p] = ctx;
  eom_out[p] = eom ? 1 : 0;
}

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

// The head and the table of the wrapper's 512 contexts at most fit the
// 48 KB of shared memory a launch may take without opting in.
extern "C" int repro_match_first(const void* data, int64_t n,
                                 int64_t row_bytes, const void* rules,
                                 const void* modes, int n_ctx,
                                 const void* valid, void* ctx_id, void* eom,
                                 void* stream) {
  if (n == 0) return 0;
  const bool head = row_bytes % 16 == 0 && row_bytes >= 4 * kHeadWords &&
                    reinterpret_cast<uintptr_t>(data) % 16 == 0;
  const size_t smem =
      (head ? (kHeadWords * kHeadStride + 3) / 4 * 16 : 0) +
      static_cast<size_t>(n_ctx) * (4 * sizeof(Rule) + 4);
  const unsigned blocks = static_cast<unsigned>((n + kFrames - 1) / kFrames);
  auto kernel = head ? match_first_kernel<true> : match_first_kernel<false>;
  kernel<<<blocks, kFrames, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, row_bytes,
      static_cast<const int64_t*>(rules), static_cast<const int32_t*>(modes),
      n_ctx, static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(ctx_id), static_cast<uint8_t*>(eom));
  return static_cast<int>(cudaGetLastError());
}

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
