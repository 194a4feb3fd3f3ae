// K4b: the backward of flash attention (K4), for sm_90a, by recompute.
//
// The TPU package has no backward kernel: its models train through plain
// blockwise_attention (src/repro/models/attention.py:94), which XLA
// differentiates.  The port's forward runs on K4, so its gradient is this
// kernel.  It computes the gradients of what flash_attention_ref computes
// (scale 1/sqrt(D), absolute positions from 0, causal keeps j <= i, window
// > 0 keeps j > i - window, an optional per-batch key length kv_len keeps
// j < kv_len[b], a fully masked row gives 0) without storing the scores: with P = exp(S - lse) recomputed tile by tile from the row
// log-sum-exp that K4's forward wrote (+inf for a row with no live key),
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),  Delta_i = dO_i . O_i,
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D).
// Inputs q, o, dO (B, Sq, H, D) and k, v (B, Sk, KV, D), contiguous, and
// lse float32 (B, H, Sq); query head h reads KV head h / (H / KV).
// bfloat16 or float32, D 64, 128 or 256; every sum is float32.
//
// kv_len (null, or int32 (B,) with every value in [1, Sk], as K4 takes it:
// whisper's cross-attention) cuts batch row b's keys to [0, kv_len[b]).  It
// is a loop bound, as in K4's forward: the dQ kernel's key range ends at
// min(Sk, kv_len[b]) and its ragged-end mask cuts there; a dK/dV block
// whose key tile starts at or past kv_len[b] takes no step and writes zero
// partial sums, and in the tile that straddles it P^T is 0 for the keys at
// or past it, so their dK and dV rows come out exactly 0, as the plain
// backward gives.  Delta and the ordered reduction do not change: the lse
// that K4's forward wrote already excludes those keys.
//
// bfloat16 (the model's dtype), three kernels in stream order, each block
// of the first two built as K4's forward is: one producer warpgroup that
// gives its registers up (setmaxnreg.dec) and issues every load by TMA
// (rank-4 maps with 128-byte swizzle, rows past S read as zeros) into a
// ring of shared-memory stages guarded by full and empty mbarriers (2
// stages at D = 256, 4 below), and two consumer warpgroups that run every
// product as wgmma on those tiles.  Tiles are 64 query rows by 64
// keys.
//  * dq_wgmma_kernel, a block per (query tile, head, batch), the longest
//    causal walks first: Q and dO come in once, then K and V tiles stream
//    through the ring.  The consumers read the rows' lse and compute their
//    Delta (the diagonal of O dO^T on the tensor cores, the same sum as
//    dP's), and write both, lse in log2 units, into padded (B, H, Sq
//    rounded up to 64) buffers for the dK/dV kernel (+inf and 0 past Sq,
//    so that kernel needs no row mask).  Consumer 0 computes
//    S = Q K^T and P = exp2(S scale log2(e) - lse log2(e)) and hands P to
//    consumer 1 in float32 through shared memory (two named barriers);
//    consumer 1 computes dP = dO V^T, dS = P (dP - Delta), splits dS into
//    a bfloat16 pair hi + lo in the accumulator's layout (wgmma's
//    A-register layout; see split_bf16) and adds hi K + lo K to dQ, K read
//    as the MN-major (transposed) operand.  S and
//    dP are m64n64 products with both operands in shared memory; dQ (64 x
//    D float32, D / 2 registers a thread) stays in consumer 1's registers.
//    Consumer 0 releases a stage once S is done and runs a tile ahead, so
//    its S and softmax overlap consumer 1's products.
//  * dkv_wgmma_kernel, a block per (key tile, KV head, batch, split): K and
//    V come in once; the (Q, dO, lse, Delta) of each (query head of the
//    group, query tile) step that can see the tile stream through the
//    ring (causal: from the tile on; window: up to W - 1 past its end).
//    Consumer 0 computes S^T = K Q^T, forms P^T, hands it to consumer 1 in
//    float32 through shared memory (two named barriers) and adds P^T dO
//    to dV; consumer 1 computes dP^T = V dO^T, forms dS^T = P^T (dP^T -
//    Delta) and adds dS^T Q to dK, each operand in registers split into a
//    bfloat16 pair as in the dQ kernel.  So each holds one 64 x D float32 sum
//    (at D = 256 a thread holds 128 of them, with S^T or dP^T beside it),
//    and all five products run on wgmma with dO and Q as MN-major
//    operands, no transpose through shared memory.  A tile's steps are
//    split evenly among as many blocks as they need at a cap that the
//    launcher picks (plan_dkv) to fill one wave of the SMs: at gemma3-1b's
//    train shape a layer has only 64 key tiles, and under the causal mask
//    the first sees 16 times the steps of the last.  Each block writes
//    float32 partial sums into a scratch buffer.
//  * dkv_reduce_kernel adds the splits' partial sums in split order and
//    rounds dK and dV to bfloat16.  The G query heads of a KV group meet
//    inside the blocks and the splits in a fixed order: no atomics, and the
//    result is the same on every run.
// Only the tiles on the causal diagonal, at the window's edge or at the
// ragged end of the keys are masked, on the accumulators, outside the
// wgmma issue (ptxas serialises a wgmma under a branch).
//
// The register operands of the last three products (dS for dQ and dK, P^T
// for dV) are each split into a bfloat16 pair hi + lo (split_bf16) and the
// product runs twice: the sums then keep about 16 bits of each value where
// one bfloat16 keeps 8.  On whisper-tiny's cross-attention in training,
// whose dS cancels over the keys (an encoder output of small stub frames),
// one bfloat16 cost up to 0.2 of a dQ row's RMS, as a plain version that
// rounds dS so showed; split, the error is the float32 sums'.  The split
// adds three of the seven m64 products a tile.
//
// float32 (tests and small configurations), on the CUDA cores: tiles of
// 16 query rows by 32 keys (dq_kernel, dkv_kernel; a warp computes 2 rows x
// 32 keys of S and dP, a thread one key and two rows), one block per key
// tile, dK and dV written directly; lse from K4's forward as above.
//
// Key tiles that the masks remove for a whole query tile, and query tiles
// that cannot see a key tile, are never visited.
//
// What bounds it on the H100: by the count, operations, 10 D per live
// (query, key) pair (S, dP, dV, dK, dQ), against the bytes of q, k, v, o,
// dO and the three gradients.  This design does 20 D: the dQ kernel
// recomputes S and dP so that no kernel needs float32 atomics, and the
// split operands run dQ, dK and dV twice.  As
// measured at gemma3-1b's train shape (D 256), the streaming of tiles
// into each SM: every 64 x 64 step brings in 64 KiB, and a build whose
// consumers only wait for each stage and release it took two thirds of
// the kernels' time.  Shared memory holds only 2 stages beside the
// resident operands at D 256, and registers rule out wider tiles (a
// warpgroup holds one 64 x 256 float32 sum); so the design keeps the
// consumers off the load path and balances the dK/dV walk over the SMs.
//
// Built with -DREPRO_K4B_PLANTED_FAULTS, the library is instead the
// variant that the checks hold to fail (repro_flash_attention_bwd_planted):
// fault 1 drops one key tile from the dK/dV work (its dK, dV rows stay 0),
// fault 2 leaves Delta out of dS, fault 3 reads each row's lse from the
// next row, fault 4 ignores kv_len in the dK/dV walk (the keys past it get
// nonzero rows).  The shipped library has none of them.

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;       // float32 kernels and the reduction
constexpr int BQ = 16;             // float32: query rows per tile
constexpr int BK = 32;             // float32: keys per tile, one per lane
constexpr int T64 = 64;            // bfloat16: query rows and keys per tile
constexpr int WG = 128;            // threads per warpgroup
constexpr int WG_THREADS = 3 * WG; // consumers 0 and 1, producer 2
constexpr int PRODUCER_REGS = 40;  // 128 x 40 + 256 x 232 = 384 x 168
constexpr int CONSUMER_REGS = 232;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq), natural log, from K4's forward
  const int* kv_len; // null, or (B,) in [1, Sk]: row b's keys are [0, kv_len[b])
  void* dq;
  void* dk;
  void* dv;
  float* lse2;       // bfloat16: (B, H, sq_pad), lse log2(e), +inf past Sq
  float* delta;      // float32 (B, H, Sq); bfloat16 (B, H, sq_pad), 0 past Sq
  float* part;       // bfloat16: dK, dV partial sums, 2 x splits x B Sk KV D
  int64_t b, sq, sk, h, kv, sq_pad;
  int causal, window;
  int splits;        // bfloat16: the most dK/dV blocks that share a key tile
  int64_t cap;       // bfloat16: the most steps a dK/dV block takes
  float scale;
#ifdef REPRO_K4B_PLANTED_FAULTS
  int fault;
  int64_t fault_tile;  // key tile that fault 1 drops; -1: the last
#endif
};

#ifdef REPRO_K4B_PLANTED_FAULTS
// key tile kt of n_tiles
__device__ __forceinline__ bool tile_dropped(const Args& a, int64_t kt,
                                             int64_t n_tiles) {
  return a.fault == 1 &&
         kt == (a.fault_tile < 0 ? n_tiles - 1 : a.fault_tile);
}
__device__ __forceinline__ bool delta_dropped(const Args& a) {
  return a.fault == 2;
}
__device__ __forceinline__ int64_t lse_row(const Args& a, int64_t row) {
  return a.fault == 3 && row + 1 < a.sq ? row + 1 : row;
}
__device__ __forceinline__ bool kv_len_ignored(const Args& a) {
  return a.fault == 4;
}
#else
__device__ __forceinline__ bool tile_dropped(const Args&, int64_t, int64_t) {
  return false;
}
__device__ __forceinline__ bool delta_dropped(const Args&) { return false; }
__device__ __forceinline__ int64_t lse_row(const Args&, int64_t row) {
  return row;
}
__device__ __forceinline__ bool kv_len_ignored(const Args&) { return false; }
#endif

// the live keys [0, n) of batch row bb: Sk, or kv_len[bb] when given
__device__ __forceinline__ int64_t row_keys(const Args& a, int64_t bb) {
  if (a.kv_len == nullptr) return a.sk;
  const int64_t n = a.kv_len[bb];
  return n < a.sk ? n : a.sk;
}
// the same bound as the dK/dV walk reads it
__device__ __forceinline__ int64_t dkv_keys(const Args& a, int64_t bb) {
  return kv_len_ignored(a) ? a.sk : row_keys(a, bb);
}

// query i sees key j; keys [0, keys) of the row's batch are live
__device__ __forceinline__ bool live(const Args& a, int64_t i, int64_t j,
                                     int64_t keys) {
  return i < a.sq && j < keys && (!a.causal || j <= i) &&
         (a.window <= 0 || j > i - a.window);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// rows [row0, row0 + n) of a (rows, heads, D) slab at head hh into a
// shared-memory tile of row stride ld; rows past `limit` are 0
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int64_t row0, int n, int64_t limit,
                                          int64_t heads, int64_t hh) {
  for (int e = threadIdx.x; e < n * D; e += THREADS) {
    int r = e / D, d = e % D;
    int64_t row = row0 + r;
    dst[r * ld + d] = row < limit ? src[(row * heads + hh) * D + d]
                                  : 0.f;
  }
}

// s[r] = q_row(r) . k_row(lane) and p[r] = do_row(r) . v_row(lane) for
// the warp's rows w and w + 8; q/do rows of stride D (broadcast 16-byte
// reads), k/v rows of stride D + 1 (one bank per lane)
template <int D>
__device__ __forceinline__ void dots(const float* Qs, const float* dOs,
                                     const float* Ks, const float* Vs, int w,
                                     int lane, float s[2], float p[2]) {
  s[0] = s[1] = p[0] = p[1] = 0.f;
  const float* kr = Ks + lane * (D + 1);
  const float* vr = Vs + lane * (D + 1);
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 q0 = *reinterpret_cast<const float4*>(Qs + w * D + d);
    float4 q1 = *reinterpret_cast<const float4*>(Qs + (w + 8) * D + d);
    float4 o0 = *reinterpret_cast<const float4*>(dOs + w * D + d);
    float4 o1 = *reinterpret_cast<const float4*>(dOs + (w + 8) * D + d);
    float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
    float v0 = vr[d], v1 = vr[d + 1], v2 = vr[d + 2], v3 = vr[d + 3];
    s[0] += q0.x * k0 + q0.y * k1 + q0.z * k2 + q0.w * k3;
    s[1] += q1.x * k0 + q1.y * k1 + q1.z * k2 + q1.w * k3;
    p[0] += o0.x * v0 + o0.y * v1 + o0.z * v2 + o0.w * v3;
    p[1] += o1.x * v0 + o1.y * v1 + o1.z * v2 + o1.w * v3;
  }
}

// key tiles [lo, hi) that query rows [q0, q0 + BQ) can see, of keys
// [0, keys)
__device__ __forceinline__ void key_tiles(const Args& a, int64_t q0,
                                          int64_t keys, int64_t& lo,
                                          int64_t& hi) {
  int64_t kmin = a.window > 0 ? q0 - a.window + 1 : 0;
  int64_t kmax = a.causal ? q0 + BQ : keys;        // exclusive
  if (kmin < 0) kmin = 0;
  if (kmax > keys) kmax = keys;
  lo = kmin / BK;
  hi = kmax > kmin ? (kmax + BK - 1) / BK : lo;
}

// ------------------------------------------- float32, CUDA cores: dQ
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                          // BQ x D
  float* dOs = Qs + BQ * D;                  // BQ x D
  float* Ks = dOs + BQ * D;                  // BK x (D + 1)
  float* Vs = Ks + BK * (D + 1);             // BK x (D + 1)
  float* dSs = Vs + BK * (D + 1);            // BQ x BK
  float* lse_s = dSs + BQ * BK;              // BQ
  float* dl_s = lse_s + BQ;                  // BQ

  const int64_t n_qt = (a.sq + BQ - 1) / BQ;
  // causal: the last query tiles see the most keys; run them first
  const int64_t qt = a.causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int64_t hh = blockIdx.y, bb = blockIdx.z;
  const int64_t g = a.h / a.kv, kvh = hh / g;
  const int64_t q0 = qt * BQ;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;

  const float* q = static_cast<const float*>(a.q) + bb * a.sq * a.h * D;
  const float* o = static_cast<const float*>(a.o) + bb * a.sq * a.h * D;
  const float* dout = static_cast<const float*>(a.dout) + bb * a.sq * a.h * D;
  const float* k = static_cast<const float*>(a.k) + bb * a.sk * a.kv * D;
  const float* v = static_cast<const float*>(a.v) + bb * a.sk * a.kv * D;

  load_rows<D>(Qs, D, q, q0, BQ, a.sq, a.h, hh);
  load_rows<D>(dOs, D, dout, q0, BQ, a.sq, a.h, hh);

  // Delta and lse of rows w and w + 8 (a row with no live key: lse +inf,
  // so P = exp(s - inf) = 0 everywhere), in shared memory for the loop
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int64_t row = q0 + w + 8 * r;
    float acc = 0.f;
    if (row < a.sq)
      for (int d = lane; d < D; d += 32)
        acc += dout[(row * a.h + hh) * D + d] * o[(row * a.h + hh) * D + d];
    acc = delta_dropped(a) ? 0.f : warp_sum(acc);
    if (lane == 0) {
      dl_s[w + 8 * r] = acc;
      lse_s[w + 8 * r] =
          row < a.sq ? a.lse[(bb * a.h + hh) * a.sq + lse_row(a, row)]
                     : INFINITY;
      if (row < a.sq) a.delta[(bb * a.h + hh) * a.sq + row] = acc;
    }
  }

  const int64_t keys = row_keys(a, bb);
  int64_t kt_lo, kt_hi;
  key_tiles(a, q0, keys, kt_lo, kt_hi);

  // dQ[i][d] += sum_j dS[i][j] K[j][d]; a thread owns column d = tid % D
  // of rows [ib * RN, ib * RN + RN)
  constexpr int RN = BQ * D / THREADS;
  const int dcol = threadIdx.x % D, ib = threadIdx.x / D;
  float acc[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) acc[r] = 0.f;
  for (int64_t kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();
    load_rows<D>(Ks, D + 1, k, kt * BK, BK, a.sk, a.kv, kvh);
    load_rows<D>(Vs, D + 1, v, kt * BK, BK, a.sk, a.kv, kvh);
    __syncthreads();
    float s[2], dp[2];
    dots<D>(Qs, dOs, Ks, Vs, w, lane, s, dp);
    const int64_t j = kt * BK + lane;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ri = w + 8 * r;
      float p = live(a, q0 + ri, j, keys)
                    ? __expf(s[r] * a.scale - lse_s[ri])
                    : 0.f;
      dSs[ri * BK + lane] = p * (dp[r] - dl_s[ri]);
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < BK; jj += 4) {
      float k0 = Ks[jj * (D + 1) + dcol], k1 = Ks[(jj + 1) * (D + 1) + dcol];
      float k2 = Ks[(jj + 2) * (D + 1) + dcol];
      float k3 = Ks[(jj + 3) * (D + 1) + dcol];
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        float4 ds = *reinterpret_cast<const float4*>(
            dSs + (ib * RN + r) * BK + jj);
        acc[r] += ds.x * k0 + ds.y * k1 + ds.z * k2 + ds.w * k3;
      }
    }
  }
  float* dq = static_cast<float*>(a.dq) + bb * a.sq * a.h * D;
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    int64_t row = q0 + ib * RN + r;
    if (row < a.sq) dq[(row * a.h + hh) * D + dcol] = acc[r] * a.scale;
  }
}

// --------------------------------------- float32, CUDA cores: dK, dV
template <int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(Args a) {
  extern __shared__ float smem[];
  float* Ks = smem;                          // BK x (D + 1)
  float* Vs = Ks + BK * (D + 1);             // BK x (D + 1)
  float* Qs = Vs + BK * (D + 1);             // BQ x D
  float* dOs = Qs + BQ * D;                  // BQ x D
  float* Ps = dOs + BQ * D;                  // BQ x BK
  float* dSs = Ps + BQ * BK;                 // BQ x BK
  float* lse_s = dSs + BQ * BK;              // BQ
  float* dl_s = lse_s + BQ;                  // BQ

  const int64_t kt = blockIdx.x;             // causal: tile 0 sees most
  const int64_t kvh = blockIdx.y, bb = blockIdx.z;
  const int64_t g = a.h / a.kv;
  const int64_t k0 = kt * BK;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;

  const float* q = static_cast<const float*>(a.q) + bb * a.sq * a.h * D;
  const float* dout = static_cast<const float*>(a.dout) + bb * a.sq * a.h * D;
  const float* k = static_cast<const float*>(a.k) + bb * a.sk * a.kv * D;
  const float* v = static_cast<const float*>(a.v) + bb * a.sk * a.kv * D;
  const float* lse = a.lse + bb * a.h * a.sq;
  const float* delta = a.delta + bb * a.h * a.sq;

  load_rows<D>(Ks, D + 1, k, k0, BK, a.sk, a.kv, kvh);
  load_rows<D>(Vs, D + 1, v, k0, BK, a.sk, a.kv, kvh);

  // query tiles that can see keys [k0, k0 + BK); none past kv_len
  const int64_t keys = dkv_keys(a, bb);
  int64_t qmin = a.causal ? k0 : 0;
  int64_t qmax = a.sq;                                   // exclusive
  if (a.window > 0 && k0 + BK - 1 + a.window < qmax)
    qmax = k0 + BK - 1 + a.window;
  int64_t qt_lo = qmin / BQ, qt_hi = qmax > qmin ? (qmax + BQ - 1) / BQ : 0;
  if (tile_dropped(a, kt, gridDim.x) || k0 >= keys) qt_hi = 0;

  // a thread owns column d = tid % D of keys [jb * JN, jb * JN + JN)
  constexpr int JN = BK * D / THREADS;
  const int dcol = threadIdx.x % D, jb = threadIdx.x / D;
  float dk[JN], dv[JN];
#pragma unroll
  for (int c = 0; c < JN; ++c) dk[c] = dv[c] = 0.f;

  for (int64_t gi = 0; gi < g; ++gi) {
    const int64_t hh = kvh * g + gi;
    for (int64_t qt = qt_lo; qt < qt_hi; ++qt) {
      const int64_t q0 = qt * BQ;
      __syncthreads();
      load_rows<D>(Qs, D, q, q0, BQ, a.sq, a.h, hh);
      load_rows<D>(dOs, D, dout, q0, BQ, a.sq, a.h, hh);
      if (threadIdx.x < BQ) {
        int64_t row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.sq ? lse[hh * a.sq + lse_row(a, row)]
                                        : INFINITY;
        dl_s[threadIdx.x] = row < a.sq ? delta[hh * a.sq + row] : 0.f;
      }
      __syncthreads();
      float s[2], dp[2];
      dots<D>(Qs, dOs, Ks, Vs, w, lane, s, dp);
      const int64_t j = k0 + lane;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int ri = w + 8 * r;
        float p = live(a, q0 + ri, j, keys)
                      ? __expf(s[r] * a.scale - lse_s[ri])
                      : 0.f;
        Ps[ri * BK + lane] = p;
        dSs[ri * BK + lane] = p * (dp[r] - dl_s[ri]);
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float qv = Qs[i * D + dcol], ov = dOs[i * D + dcol];
#pragma unroll
        for (int c = 0; c < JN; c += 4) {
          float4 p4 = *reinterpret_cast<const float4*>(Ps + i * BK + jb * JN + c);
          float4 s4 = *reinterpret_cast<const float4*>(dSs + i * BK + jb * JN + c);
          dv[c] += p4.x * ov;
          dv[c + 1] += p4.y * ov;
          dv[c + 2] += p4.z * ov;
          dv[c + 3] += p4.w * ov;
          dk[c] += s4.x * qv;
          dk[c + 1] += s4.y * qv;
          dk[c + 2] += s4.z * qv;
          dk[c + 3] += s4.w * qv;
        }
      }
    }
  }
  float* dkp = static_cast<float*>(a.dk) + bb * a.sk * a.kv * D;
  float* dvp = static_cast<float*>(a.dv) + bb * a.sk * a.kv * D;
#pragma unroll
  for (int c = 0; c < JN; ++c) {
    int64_t key = k0 + jb * JN + c;
    if (key < a.sk) {
      dkp[(key * a.kv + kvh) * D + dcol] = dk[c] * a.scale;
      dvp[(key * a.kv + kvh) * D + dcol] = dv[c];
    }
  }
}

// ------------------------------------------- bfloat16: TMA and wgmma
template <int D>
struct Tiles {
  static constexpr int STAGES = D == 256 ? 2 : 4;
  static constexpr int PANELS = D / 64;            // 64-column TMA boxes a row
  static constexpr int PANEL = T64 * ROW_BYTES;    // 64 rows of one panel
  static constexpr int TILE = PANELS * PANEL;      // one 64-row tile
  static constexpr int STAT = 2 * T64 * 4;         // lse2, Delta of 64 rows
  static constexpr int XP = 32 * WG * 4;           // P or P^T, 32 floats a
                                                   // consumer thread
  // dQ kernel: Q, dO; per stage K, V; the P exchange; barriers (Q and dO
  // full; per stage K/V full, K/V empty)
  static constexpr int DQ_BAR = (2 + 2 * STAGES) * TILE + XP;
  static constexpr int DQ_SMEM = DQ_BAR + 8 * (1 + 2 * STAGES) + 1024;
  // dK/dV kernel: K, V; per stage Q, dO and statistics; the P^T exchange;
  // barriers (K/V full; per stage full, empty)
  static constexpr int DKV_BAR = (2 + 2 * STAGES) * TILE + STAGES * STAT + XP;
  static constexpr int DKV_SMEM = DKV_BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// the (query head of the group, query tile) steps that can see key tile t
// (64 keys): causal from the tile on, window up to W - 1 past its end
__host__ __device__ __forceinline__ int64_t tile_steps(const Args& a,
                                                       int64_t t) {
  const int64_t k0 = t * T64;
  const int64_t qmin = a.causal ? k0 : 0;
  int64_t qmax = a.sq;
  if (a.window > 0 && k0 + T64 - 1 + a.window < qmax)
    qmax = k0 + T64 - 1 + a.window;
  return qmax > qmin
             ? a.h / a.kv * ((qmax + T64 - 1) / T64 - qmin / T64) : 0;
}

// the dK/dV blocks that share key tile t, at most a.cap steps each (a tile
// that no query sees has one, which writes zeros)
__host__ __device__ __forceinline__ int tile_splits(const Args& a,
                                                    int64_t t) {
  const int64_t n = (tile_steps(a, t) + a.cap - 1) / a.cap;
  return n < 1 ? 1 : static_cast<int>(n);
}

// the key tile and split of dK/dV block x (blocks run tile by tile, each
// tile's splits in order), by one warp: a prefix sum of tile_splits over
// 32 tiles at a time
__device__ __forceinline__ void find_tile(const Args& a, int x, int n_kt,
                                          int* tile, int* split) {
  const int lane = threadIdx.x % 32;
  int acc = 0;
  for (int base = 0; base < n_kt; base += 32) {
    const int t = base + lane;
    const int n = t < n_kt ? tile_splits(a, t) : 0;
    int incl = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const int start = acc + incl - n;
    const unsigned hit =
        __ballot_sync(0xffffffffu, n > 0 && x >= start && x < start + n);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int first = __shfl_sync(0xffffffffu, start, src);
      if (lane == 0) {
        *tile = base + src;
        *split = x - first;
      }
      return;
    }
    acc += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// the bfloat16 pair nearest (a, b), in hi, and the pair nearest what it
// leaves over, in lo: a = hi.x + lo.x to about 16 significant bits, so a
// product taken with hi and again with lo keeps that precision
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

#define KB_ACC8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (m64 x n64, f32) (+)= a . b, a (bf16) from registers, b (K-major) from
// shared memory
__device__ __forceinline__ void wgmma_rs_n64_kmajor(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : KB_ACC8(0), KB_ACC8(8), KB_ACC8(16), KB_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef KB_ACC8

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, Args a) {
  using T = Tiles<D>;
  constexpr int S = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;    // swizzle atoms: 1 KiB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sdO = base + T::TILE;
  auto sK = [&](int s) { return base + (2 + s) * T::TILE; };
  auto sV = [&](int s) { return base + (2 + S + s) * T::TILE; };
  float* xp = reinterpret_cast<float*>(smem + (2 + 2 * S) * T::TILE);
  const uint32_t q_full = base + T::DQ_BAR;
  auto kv_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto kv_empty = [&](int s) { return q_full + 8u * (1 + S + s); };

  const int sq = static_cast<int>(a.sq);
  const int h = static_cast<int>(a.h);
  // block order: the last query tile of every (batch, head) first (under
  // the causal mask the longest walks); heads of one KV head are neighbours
  const int n_qt = (sq + T64 - 1) / T64;
  const int bh = gridDim.x / n_qt;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / bh) * T64;
  const int bi = static_cast<int>(blockIdx.x) % bh / h;
  const int hi = static_cast<int>(blockIdx.x) % bh % h;
  const int kvh = hi / (h / static_cast<int>(a.kv));
  // this batch row's keys [0, keys): kv_len ends the walk, as in K4's forward
  const int keys = static_cast<int>(row_keys(a, bi));
  // the key tiles that hold a live key for some row of the tile
  const int k_hi = a.causal ? min(keys, min(sq, q0 + T64)) : keys;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kb0 = k_lo / T64;
  const int n_kt = k_hi > k_lo ? (k_hi + T64 - 1) / T64 - kb0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(q_full, 2 * T::TILE);
#pragma unroll
      for (int p = 0; p < T::PANELS; ++p) {
        tma_load(sQ + p * T::PANEL, &tq, q_full, p * 64, q0, hi, bi);
        tma_load(sdO + p * T::PANEL, &tdo, q_full, p * 64, q0, hi, bi);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % S, n = i / S, key0 = (kb0 + i) * T64;
        if (n > 0) mbar_wait(kv_empty(s), (n - 1) & 1);
        mbar_expect_tx(kv_full(s), 2 * T::TILE);
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p) {
          tma_load(sK(s) + p * T::PANEL, &tk, kv_full(s), p * 64, key0, kvh,
                   bi);
          tma_load(sV(s) + p * T::PANEL, &tv, kv_full(s), p * 64, key0, kvh,
                   bi);
        }
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int g = lane >> 2, tq4 = lane & 3;
  // Consumer 0: S = Q K^T, P = exp2(S scale log2(e) - lse log2(e)), handed
  // to consumer 1 in float32 through xp.  Consumer 1: dP = dO V^T, dS = P
  // (dP - Delta), dQ += dS K.  Named barrier 3: P is in xp; 2: consumer 1
  // has read it.  Consumer 0 releases K and V once S is done, consumer 1
  // once dQ is, so consumer 0 runs a tile ahead: its S and softmax overlap
  // consumer 1's products.  Each thread's accumulator rows (element 4j +
  // e): ra for e < 2, else rb; key 8j + 2 tq4 + (e & 1) of the tile.  The
  // rows' lse (consumer 0, read while the first tiles load) and Delta
  // (consumer 1, computed once Q and dO are in) are each thread's own, and
  // written by the quad's first thread into the dK/dV kernel's padded
  // buffers (+inf and 0 past Sq, so that kernel needs no row mask).
  const int ra = 16 * warp + g, rb = ra + 8;
  const int row_a = q0 + ra, row_b = q0 + rb;
  const float scale_log2 = a.scale * LOG2E;
  const int64_t stat0 = (static_cast<int64_t>(bi) * h + hi) * a.sq_pad + q0;
  if (wg == 0) {
    const float* lr = a.lse + (static_cast<int64_t>(bi) * h + hi) * sq;
    const float lse_a =
        row_a < sq ? lr[lse_row(a, row_a)] * LOG2E : INFINITY;
    const float lse_b =
        row_b < sq ? lr[lse_row(a, row_b)] * LOG2E : INFINITY;
    if (tq4 == 0) {
      a.lse2[stat0 + ra] = lse_a;
      a.lse2[stat0 + rb] = lse_b;
    }
    mbar_wait(q_full, 0);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % S;
      mbar_wait(kv_full(s), (i / S) & 1);
      float x[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks / 4) * T::PANEL + (ks % 4) * 32;
        wgmma_ss_n64(x, smem_desc(sQ + off, 16, 1024),
                     smem_desc(sK(s) + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      mbar_arrive(kv_empty(s));
      const int c0 = (kb0 + i) * T64;
      if (c0 + T64 - 1 >= keys || (a.causal && c0 + T64 - 1 > q0) ||
          (a.window > 0 && c0 <= q0 + T64 - 1 - a.window)) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int row = (j >> 1) & 1 ? row_b : row_a;
          const int col = c0 + 8 * (j >> 2) + 2 * tq4 + (j & 1);
          bool ok = col < keys;
          if (a.causal) ok = ok && col <= row;
          if (a.window > 0) ok = ok && col > row - a.window;
          if (!ok) x[j] = -INFINITY;
        }
      }
#pragma unroll
      for (int j = 0; j < 32; ++j)
        x[j] = exp2_ftz(fmaf(x[j], scale_log2,
                             -((j >> 1) & 1 ? lse_b : lse_a)));
      if (i > 0) bar_sync(2, 2 * WG);
#pragma unroll
      for (int j = 0; j < 32; ++j) xp[j * WG + t] = x[j];
      bar_arrive(3, 2 * WG);
    }
    return;
  }
  mbar_wait(q_full, 0);
  // Delta = rowsum(dO * O) of rows ra and rb: the diagonal of O dO^T, one
  // wgmma per k16 step with O's rows in registers (A, loaded from global
  // memory in the accumulator's layout) and the tile's dO (B, K-major), so
  // that Delta is the same tensor-core sum as dP = dO V^T.  Where a row's
  // live keys reduce to one (its O is that key's V), dP - Delta is then 0
  // exactly, as it is in exact arithmetic, and so are dS, that row's dQ
  // and that key's dK (one float32 sum against another left a rounding
  // residue there, as large as a tenth of the rows' RMS floor on
  // whisper-tiny's cross-attention in training).  Rows past Sq read 0.
  float dl_a, dl_b;
  {
    const uint32_t* o = static_cast<const uint32_t*>(a.o);  // bf16 pairs
    const int64_t oa = ((static_cast<int64_t>(bi) * sq + row_a) * h + hi) *
                       (D / 2);
    const int64_t ob = oa + static_cast<int64_t>(8) * h * (D / 2);
    uint32_t ar[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = 8 * ks + tq4;                  // columns 16 ks + 2 tq4
      ar[ks][0] = row_a < sq ? o[oa + c] : 0u;
      ar[ks][1] = row_b < sq ? o[ob + c] : 0u;
      ar[ks][2] = row_a < sq ? o[oa + c + 4] : 0u;
      ar[ks][3] = row_b < sq ? o[ob + c + 4] : 0u;
    }
    float x[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * T::PANEL + (ks % 4) * 32;
      wgmma_rs_n64_kmajor(x, ar[ks], smem_desc(sdO + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    // element (row ra, column ra) is the quad's thread tq4 = g / 2, at
    // x[8 warp + g % 2]; (rb, rb) at x[8 warp + 6 + g % 2]
    float va = 0.f, vb = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i == 8 * warp + (g & 1)) va = x[i];
      if (i == 8 * warp + 6 + (g & 1)) vb = x[i];
    }
    const int owner = (lane & ~3) | (g >> 1);
    dl_a = __shfl_sync(0xffffffffu, va, owner);
    dl_b = __shfl_sync(0xffffffffu, vb, owner);
    if (delta_dropped(a)) dl_a = dl_b = 0.f;
    if (tq4 == 0) {
      a.delta[stat0 + ra] = dl_a;
      a.delta[stat0 + rb] = dl_b;
    }
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % S;
    mbar_wait(kv_full(s), (i / S) & 1);
    float x[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * T::PANEL + (ks % 4) * 32;
      wgmma_ss_n64(x, smem_desc(sdO + off, 16, 1024),
                   smem_desc(sV(s) + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    bar_sync(3, 2 * WG);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      x[j] = xp[j * WG + t] * (x[j] - ((j >> 1) & 1 ? dl_b : dl_a));
    if (i + 1 < n_kt) bar_arrive(2, 2 * WG);
    // dS as bf16 pairs hi + lo: the A registers of the four k16 steps
    // (keys) of dS K
    uint32_t da[4][4], dl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], da[kk][r],
                   dl[kk][r]);
    // dQ += dS K, K as the MN-major operand
    wgmma_fence();
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t kd =
          smem_desc(sK(s) + kk * 16 * ROW_BYTES, T::PANEL, 1024);
      wgmma_rs_nd<D>(dq, da[kk], kd);
      wgmma_rs_nd<D>(dq, dl[kk], kd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(kv_empty(s));
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq);
  const int64_t oa = ((static_cast<int64_t>(bi) * sq + row_a) * h + hi) * D;
  const int64_t ob = ((static_cast<int64_t>(bi) * sq + row_b) * h + hi) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tq4;
    if (row_a < sq)
      *reinterpret_cast<uint32_t*>(out + oa + col) =
          pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
    if (row_b < sq)
      *reinterpret_cast<uint32_t*>(out + ob + col) =
          pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, Args a) {
  using T = Tiles<D>;
  constexpr int S = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;    // swizzle atoms: 1 KiB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + T::TILE;
  auto sQ = [&](int s) { return base + (2 + s) * T::TILE; };
  auto sdO = [&](int s) { return base + (2 + S + s) * T::TILE; };
  float* stats = reinterpret_cast<float*>(smem + (2 + 2 * S) * T::TILE);
  float* xp = stats + S * 2 * T64;
  const uint32_t kv_full = base + T::DKV_BAR;
  auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + S + s); };

  // blockIdx.x is the split sp of key tile kt (the launcher gives each tile
  // as many as its steps need at a.cap steps a block)
  const int n_kt = static_cast<int>((a.sk + T64 - 1) / T64);
  __shared__ int where[2];
  if (threadIdx.x < 32) find_tile(a, blockIdx.x, n_kt, &where[0], &where[1]);
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int kt = where[0], sp = where[1];
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int h = static_cast<int>(a.h), group = h / static_cast<int>(a.kv);
  const int k0 = kt * T64;
  // this batch row's keys [0, keys): a tile at or past kv_len takes no step
  // and writes zeros, as a tile that no query sees does
  const int keys = static_cast<int>(dkv_keys(a, bi));
  // the query tiles that can see keys k0 .. k0 + 63
  const int64_t qmin = a.causal ? k0 : 0;
  int64_t qmax = a.sq;
  if (a.window > 0 && k0 + T64 - 1 + static_cast<int64_t>(a.window) < qmax)
    qmax = k0 + T64 - 1 + a.window;
  const int qt_lo = static_cast<int>(qmin / T64);
  const int n_q = qmax > qmin && k0 < keys && !tile_dropped(a, kt, n_kt)
                      ? static_cast<int>((qmax + T64 - 1) / T64) - qt_lo : 0;
  // this block's share of the tile's (head, query tile) steps; it writes
  // partial sums that dkv_reduce_kernel adds
  const int64_t total = static_cast<int64_t>(group) * n_q;
  const int n_sp = tile_splits(a, kt);
  const int it_lo = static_cast<int>(total * sp / n_sp);
  const int n_it = static_cast<int>(total * (sp + 1) / n_sp) - it_lo;

  const int wg = threadIdx.x / WG;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(kv_full, 2 * T::TILE);
#pragma unroll
      for (int p = 0; p < T::PANELS; ++p) {
        tma_load(sK + p * T::PANEL, &tk, kv_full, p * 64, k0, kvh, bi);
        tma_load(sV + p * T::PANEL, &tv, kv_full, p * 64, k0, kvh, bi);
      }
      for (int n = 0; n < n_it; ++n) {
        const int s = n % S, it = it_lo + n;
        const int hh = kvh * group + it / n_q;
        const int q0 = (qt_lo + it % n_q) * T64;
        if (n >= S) mbar_wait(empty(s), (n / S - 1) & 1);
        mbar_expect_tx(full(s), 2 * T::TILE + T::STAT);
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p) {
          tma_load(sQ(s) + p * T::PANEL, &tq, full(s), p * 64, q0, hh, bi);
          tma_load(sdO(s) + p * T::PANEL, &tdo, full(s), p * 64, q0, hh, bi);
        }
        const int64_t off = (static_cast<int64_t>(bi) * h + hh) * a.sq_pad + q0;
        float* st = stats + s * 2 * T64;
        bulk_load(smem_u32(st), a.lse2 + off, T64 * 4, full(s));
        bulk_load(smem_u32(st + T64), a.delta + off, T64 * 4, full(s));
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  // Consumer 0: S^T = K Q^T, P^T, dV += P^T dO.  Consumer 1: dP^T = V dO^T,
  // dS^T = P^T (dP^T - Delta), dK += dS^T Q.  Named barrier 2: P^T is in
  // xp; 1: consumer 1 has read it.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int g = lane >> 2, tq4 = lane & 3;
  // this thread's accumulator rows are keys ka, kb of the tile (element
  // 4j + e: key ka for e < 2, else kb; query 8j + 2 tq4 + (e & 1))
  const int key_a = k0 + 16 * warp + g, key_b = key_a + 8;
  const float scale_log2 = a.scale * LOG2E;
  const uint32_t op_a = wg == 0 ? sK : sV;       // S^T or dP^T
  float acc[D / 2];                              // dV or dK
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(kv_full, 0);
  for (int n = 0; n < n_it; ++n) {
    const int s = n % S, it = it_lo + n;
    const int q0 = (qt_lo + it % n_q) * T64;
    const float* st = stats + s * 2 * T64;
    const uint32_t op_b = wg == 0 ? sQ(s) : sdO(s);
    mbar_wait(full(s), (n / S) & 1);
    float x[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * T::PANEL + (ks % 4) * 32;
      wgmma_ss_n64(x, smem_desc(op_a + off, 16, 1024),
                   smem_desc(op_b + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    if (wg == 0) {
      // keys at or past kv_len (and past Sk, whose rows are not written)
      // get P^T = 0, so dS^T = 0 too: their dK and dV rows stay exactly 0
      if (k0 + T64 - 1 >= keys || (a.causal && k0 + T64 - 1 > q0) ||
          (a.window > 0 && k0 <= q0 + T64 - 1 - a.window)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = (i >> 1) & 1 ? key_b : key_a;
          const int qi = q0 + 8 * (i >> 2) + 2 * tq4 + (i & 1);
          bool ok = key < keys;
          if (a.causal) ok = ok && key <= qi;
          if (a.window > 0) ok = ok && key > qi - a.window;
          if (!ok) x[i] = -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        x[i] = exp2_ftz(fmaf(x[i], scale_log2,
                             -st[8 * (i >> 2) + 2 * tq4 + (i & 1)]));
      if (n > 0) bar_sync(1, 2 * WG);
#pragma unroll
      for (int i = 0; i < 32; ++i) xp[i * WG + t] = x[i];
      bar_arrive(2, 2 * WG);
    } else {
      bar_sync(2, 2 * WG);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        x[i] = xp[i * WG + t] *
               (x[i] - st[T64 + 8 * (i >> 2) + 2 * tq4 + (i & 1)]);
      if (n + 1 < n_it) bar_arrive(1, 2 * WG);
    }
    // P^T or dS^T as bf16 pairs hi + lo: the A registers of the four k16
    // steps (queries)
    uint32_t pa[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], pa[kk][r],
                   pl[kk][r]);
    // dV += P^T dO or dK += dS^T Q, dO or Q as the MN-major operand
    const uint32_t op_c = wg == 0 ? sdO(s) : sQ(s);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t cd =
          smem_desc(op_c + kk * 16 * ROW_BYTES, T::PANEL, 1024);
      wgmma_rs_nd<D>(acc, pa[kk], cd);
      wgmma_rs_nd<D>(acc, pl[kk], cd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty(s));
  }
  // this split's partial sums: dK (consumer 1) in part[sp], dV (consumer 0)
  // in part[splits + sp]
  const int64_t n_el = a.b * a.sk * a.kv * D;
  float* out = a.part + ((wg == 0 ? a.splits : 0) + sp) * n_el +
               static_cast<int64_t>(bi) * a.sk * a.kv * D;
  const int64_t oa = (static_cast<int64_t>(key_a) * a.kv + kvh) * D;
  const int64_t ob = (static_cast<int64_t>(key_b) * a.kv + kvh) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tq4;
    if (key_a < a.sk)
      *reinterpret_cast<float2*>(out + oa + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (key_b < a.sk)
      *reinterpret_cast<float2*>(out + ob + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// dK = scale * (the splits' dK partials added in split order), dV the
// same without the scale, bfloat16 out.  A block takes red_keys<D> keys of
// one (key tile, KV head, batch), whose splits its first thread counts;
// eight elements a thread.
template <int D>
__host__ __device__ constexpr int red_keys() { return 8 * THREADS / D; }

template <int D>
__global__ void __launch_bounds__(THREADS)
dkv_reduce_kernel(Args a, int64_t n_el) {
  constexpr int RK = red_keys<D>();
  const int kt = blockIdx.x / (T64 / RK);
  const int key0 = kt * T64 + blockIdx.x % (T64 / RK) * RK;
  const int rows = min(RK, static_cast<int>(a.sk) - key0);
  __shared__ int splits;
  if (threadIdx.x == 0) splits = tile_splits(a, kt);
  __syncthreads();
  const int n_sp = splits;
  const int64_t first =
      ((static_cast<int64_t>(blockIdx.z) * a.sk + key0) * a.kv + blockIdx.y)
      * (D / 2);                                  // in pairs
  const int64_t row_pairs = a.kv * (D / 2);
  const float2* part = reinterpret_cast<const float2*>(a.part);
  for (int e = threadIdx.x; e < rows * (D / 2); e += THREADS) {
    const int64_t i = first + e / (D / 2) * row_pairs + e % (D / 2);
    float2 k = make_float2(0.f, 0.f), v = make_float2(0.f, 0.f);
    for (int sp = 0; sp < n_sp; ++sp) {
      const float2 pk = part[sp * n_el / 2 + i];
      const float2 pv = part[(a.splits + sp) * n_el / 2 + i];
      k.x += pk.x; k.y += pk.y; v.x += pv.x; v.y += pv.y;
    }
    reinterpret_cast<uint32_t*>(a.dk)[i] = pack_bf16(k.x * a.scale,
                                                     k.y * a.scale);
    reinterpret_cast<uint32_t*>(a.dv)[i] = pack_bf16(v.x, v.y);
  }
}

template <int D>
int launch_wgmma(const Args& a, int64_t dkv_blocks, cudaStream_t stream) {
  using T = Tiles<D>;
  const int b = static_cast<int>(a.b), sq = static_cast<int>(a.sq);
  const int sk = static_cast<int>(a.sk), h = static_cast<int>(a.h);
  const int kv = static_cast<int>(a.kv);
  const Strides qs{a.sq * a.h * D, a.h * D, D};
  const Strides ks{a.sk * a.kv * D, a.kv * D, D};
  const int64_t blocks = (a.sq + T64 - 1) / T64 * a.b * a.h;
  if (blocks > INT_MAX) return -1;
  // set on every launch: the limit belongs to the device that is current.
  // First, too: a runtime call binds the device's context to the calling
  // thread (autograd's backward runs on a thread of its own), which
  // cuTensorMapEncodeTiled below needs.
  cudaError_t err = cudaFuncSetAttribute(
      dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::DQ_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::DKV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq, mdo, mk, mv;
  if (!tensor_map(&mq, a.q, D, sq, h, b, qs, T64) ||
      !tensor_map(&mdo, a.dout, D, sq, h, b, qs, T64) ||
      !tensor_map(&mk, a.k, D, sk, kv, b, ks, T64) ||
      !tensor_map(&mv, a.v, D, sk, kv, b, ks, T64))
    return -2;
  dq_wgmma_kernel<D><<<static_cast<int>(blocks), WG_THREADS, T::DQ_SMEM,
                       stream>>>(mq, mdo, mk, mv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gk(static_cast<unsigned>(dkv_blocks), static_cast<unsigned>(a.kv),
                static_cast<unsigned>(a.b));
  dkv_wgmma_kernel<D><<<gk, WG_THREADS, T::DKV_SMEM, stream>>>(mq, mdo, mk,
                                                               mv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gr(
      static_cast<unsigned>((a.sk + T64 - 1) / T64 * (T64 / red_keys<D>())),
      static_cast<unsigned>(a.kv), static_cast<unsigned>(a.b));
  dkv_reduce_kernel<D><<<gr, THREADS, 0, stream>>>(a, a.b * a.sk * a.kv * D);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
constexpr int dq_smem() {
  return (2 * BQ * D + 2 * BK * (D + 1) + BQ * BK + 2 * BQ) * 4;
}
template <int D>
constexpr int dkv_smem() {
  return (2 * BK * (D + 1) + 2 * BQ * D + 2 * BQ * BK + 2 * BQ) * 4;
}

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t err;
  err = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 gq(static_cast<unsigned>((a.sq + BQ - 1) / BQ),
          static_cast<unsigned>(a.h), static_cast<unsigned>(a.b));
  dq_kernel<D><<<gq, THREADS, dq_smem<D>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 gk(static_cast<unsigned>((a.sk + BK - 1) / BK),
          static_cast<unsigned>(a.kv), static_cast<unsigned>(a.b));
  dkv_kernel<D><<<gk, THREADS, dkv_smem<D>(), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const Args& a, int64_t d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    case 256: return launch<256>(a, stream);
    default: return -1;
  }
}

int launch_bf16(const Args& a, int64_t d, int64_t dkv_blocks,
                cudaStream_t stream) {
  switch (d) {
    case 64: return launch_wgmma<64>(a, dkv_blocks, stream);
    case 128: return launch_wgmma<128>(a, dkv_blocks, stream);
    case 256: return launch_wgmma<256>(a, dkv_blocks, stream);
    default: return -1;
  }
}

// The bfloat16 dK/dV split: a.cap, the most steps a block takes, is the
// least that keeps the grid to one block per SM of the current device (one
// wave) and a tile's blocks to 8; a.splits is then the most blocks a tile
// has, and *blocks the blocks of one (batch, KV head).  Under the causal
// mask the first key tiles see 16 times the steps of the last (at
// gemma3-1b's train shape), so they get more blocks.  One wave: more blocks
// write and add more float32 partial sums (2 x splits x B Sk KV D), and
// one wave beat more on the H100.  The plan is a function of shapes: it
// plans every key tile at Sk, the worst case, and never reads kv_len (on
// the device; reading it would cost the host a synchronisation).  The
// blocks of a tile past a row's kv_len take no step and write zeros.  At
// whisper's training shapes every enc_len is enc_seq, so the plan is the
// one kv_len would give; with ragged lengths the longest rows set the
// time, as K4's forward found.
int plan_dkv(Args* a, int64_t* blocks) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_kt = (a->sk + T64 - 1) / T64;
  int64_t most = 1;
  for (int64_t t = 0; t < n_kt; ++t)
    most = tile_steps(*a, t) > most ? tile_steps(*a, t) : most;
  auto count = [&](int64_t cap) {
    a->cap = cap;
    int64_t n = 0;
    for (int64_t t = 0; t < n_kt; ++t) n += tile_splits(*a, t);
    return n;
  };
  int64_t lo = (most + 7) / 8, hi = most;     // the blocks fall as cap grows
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (count(mid) * a->kv * a->b <= sms) hi = mid;
    else lo = mid + 1;
  }
  *blocks = count(lo);
  a->splits = 1;
  for (int64_t t = 0; t < n_kt; ++t)
    a->splits = tile_splits(*a, t) > a->splits ? tile_splits(*a, t)
                                               : a->splits;
  return 0;
}

int64_t padded(int64_t sq) { return (sq + T64 - 1) / T64 * T64; }

// lay the float32 workspace out (see repro_flash_attention_bwd_workspace)
// and launch
int run(Args a, int64_t d, int dtype, float* work, cudaStream_t stream) {
  if (a.b * a.h > 65535 || a.sq > (1 << 30) ||
      a.sk > (1 << 30) || a.kv <= 0 || a.h % a.kv)
    return -1;
  if (dtype == 1) {
    a.delta = work;
    return launch_f32(a, d, stream);
  }
  if (dtype != 0) return -1;
  int64_t dkv_blocks;
  const int err = plan_dkv(&a, &dkv_blocks);
  if (err) return err;
  if (dkv_blocks > INT_MAX) return -1;
  a.sq_pad = padded(a.sq);
  a.lse2 = work;
  a.delta = work + a.b * a.h * a.sq_pad;
  a.part = a.delta + a.b * a.h * a.sq_pad;
  return launch_bf16(a, d, dkv_blocks, stream);
}

}  // namespace

// float32 scratch that repro_flash_attention_bwd needs in `work` for these
// shapes and masks: for bfloat16 the padded lse and Delta (B x H x Sq
// rounded up to 64, each) and the dK and dV partial sums (2 x splits x B
// Sk KV D, splits as plan_dkv picks it on the current device); for float32
// Delta (B x H x Sq).  -1 if the device cannot be queried.
extern "C" int64_t repro_flash_attention_bwd_workspace(
    int64_t b, int64_t sq, int64_t sk, int64_t h, int64_t kv, int64_t d,
    int dtype, int causal, int window) {
  if (dtype != 0) return b * h * sq;
  if (kv <= 0 || h % kv) return -1;
  Args a{};
  a.b = b, a.sq = sq, a.sk = sk, a.h = h, a.kv = kv;
  a.causal = causal, a.window = window > 0 ? window : 0;
  int64_t blocks;
  if (plan_dkv(&a, &blocks)) return -1;
  return 2 * b * h * padded(sq) + 2 * a.splits * b * sk * kv * d;
}

#ifndef REPRO_K4B_PLANTED_FAULTS
// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KV, D), contiguous;
// lse float32 (B, H, Sq) from K4's forward; kv_len null or int32 (B,) in
// [1, Sk]; work the workspace above.
// dtype 0 bfloat16, 1 float32.  Returns 0 or a CUDA error code (-1: a
// head_dim, dtype or shape the kernel does not take; -2: a bfloat16 tensor
// map cannot be built).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, const int* kv_len, void* dq, void* dk,
    void* dv, float* work, int64_t b, int64_t sq, int64_t sk, int64_t h,
    int64_t kv, int64_t d, int dtype, int causal, int window, void* stream) {
  Args a{q, k, v, o, dout, lse, kv_len, dq, dk, dv, nullptr, nullptr, nullptr,
         b, sq, sk, h, kv, 0, causal, window > 0 ? window : 0, 1, 1,
         1.0f / sqrtf(static_cast<float>(d))};
  return run(a, d, dtype, work, static_cast<cudaStream_t>(stream));
}
#else
// the same with a planted fault (see the top of the file)
extern "C" int repro_flash_attention_bwd_planted(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, const int* kv_len, void* dq, void* dk,
    void* dv, float* work, int64_t b, int64_t sq, int64_t sk, int64_t h,
    int64_t kv, int64_t d, int dtype, int causal, int window, int fault,
    int64_t fault_tile, void* stream) {
  Args a{q, k, v, o, dout, lse, kv_len, dq, dk, dv, nullptr, nullptr, nullptr,
         b, sq, sk, h, kv, 0, causal, window > 0 ? window : 0, 1, 1,
         1.0f / sqrtf(static_cast<float>(d)), fault, fault_tile};
  return run(a, d, dtype, work, static_cast<cudaStream_t>(stream));
}
#endif
