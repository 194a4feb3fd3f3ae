// K4: forward flash attention for the serving path's prefill, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas (body _flash_kernel), and computes what its plain
// reference flash_attention_ref computes: softmax(q k^T / sqrt(D)) v with
// float32 statistics, causal (key j <= query i) and sliding-window
// (j > i - window) masks on absolute positions from 0, and 0 for a row with
// no live key.  An optional per-batch key length kv_len (int32 (B,), the
// model-level mask of blockwise_attention in src/repro/models/attention.py,
// whisper's cross-attention) makes key j of batch row b live only if
// j < kv_len[b], on top of the other masks.
//
// Differences from the TPU kernel, by design:
//  * It reads q (B, Sq, H, D) and k/v (B, Sk, KV, D) through their strides
//    in the model's layout; query head h reads KV head h / (H / KV).  The
//    TPU wrapper repeats K/V across each GQA group and pads the sequences
//    to whole blocks; this kernel does neither.  Ragged ends are masked
//    inside the kernel, so padded keys never enter the softmax (the TPU
//    kernel lets zero-padded keys in when causal is false).
//  * Key tiles that the causal or window mask removes for the whole query
//    tile are never loaded: a local layer at window 512 reads at most
//    (512 + 128) / 64 tiles per query tile instead of up to Sk / 64.  With
//    kv_len, a block's key range ends at min(Sk, kv_len[b]) and the
//    ragged-end mask uses that bound; the tiles, the TMA ring and the
//    wgmma body are unchanged.
//  * The TPU kernel's model-level counterpart, blockwise_attention, lets
//    zero-padded keys into a non-causal softmax without kv_len; the kernel
//    computes exact attention, and repro_torch/models/attention.py appends
//    those zero keys itself where the reference has them.
//
// What bounds it on the H100: operations.  At gemma3-1b's prefill (B 4,
// S 2048, H 4, KV 1, D 256) a global layer does 4 D per live (query, key)
// pair, about 34.4 GFLOP, or 35 us at the bf16 tensor-core peak, against
// about 42 MB of q, k, v and o (13 us at 3.35 TB/s).  So the design keeps
// the tensor cores fed and the loads off their path.
//
// bfloat16 (the model's dtype): one block of three warpgroups takes a query
// tile of BQ = 128 rows of one (batch, head).
//  * Warpgroup 2, the producer, gives its registers up (setmaxnreg.dec) and
//    one of its threads issues every load through TMA: the Q tile once,
//    then K and V tiles of 64 keys into a ring of shared-memory stages (2
//    at D = 256, 4 below).  Each stage has a full barrier per operand
//    (mbarrier transaction bytes) and an empty barrier per operand on which
//    every consumer thread arrives once it is done with it.  The tensor
//    maps (rank 4: D, S, heads, B, 128-byte swizzle) are built by the
//    launcher from the tensors' strides; TMA fills rows past S with zeros.
//  * Warpgroups 0 and 1, the consumers, own 64 query rows each and take
//    the registers (setmaxnreg.inc).  S = Q K^T is wgmma m64n64k16 with Q
//    and K read from swizzled shared memory.  The online softmax (log2
//    domain, float32 max and sum) runs on the S accumulator; P is rounded
//    to bf16 in the accumulator's own layout, which is wgmma's A-register
//    layout, and O += P V is wgmma m64nDk16 with V as an MN-major
//    (transposed) shared-memory operand.  O (64 x D float32, D / 2
//    registers a thread) stays in registers.
//  * The two consumers take turns on the tensor cores (two named barriers,
//    in strict alternation): in its turn a warpgroup issues S_j = Q K_j^T
//    and O += P_{j-1} V_{j-1}, then hands the turn over and runs the
//    softmax of S_j while its P V is still in flight, so that one
//    warpgroup's softmax overlaps the other's matrix products
//    (FlashAttention-3's ping-pong and intra-warpgroup overlap).
//  * Only the tiles that need it are masked (the causal diagonal, the
//    window's edge, the ragged end); interior tiles take no mask.
//  * Epilogue: O / l in bf16 into the warpgroup's own rows of Q's shared
//    memory (the same swizzle), then one TMA store per 64 columns; TMA
//    drops rows past Sq.  When the caller passes an lse buffer (training,
//    for K4b), each row's log-sum-exp, (m + log2 l) ln 2, is stored too;
//    the serving path passes none and pays nothing for it.
//  * Blocks run the longest query tiles (causal: the last) first, and the
//    query heads of one KV head next to each other, so that a GQA group
//    reads the same K/V tiles while they are in L2.
//
// float32: one warp per query row, D / 32 elements a lane, the dot product
// reduced across the warp and the softmax updated key by key with CUDA-core
// FMA; lse as in the bfloat16 kernel.  It exists for completeness (tests,
// small float32 configurations); the serving path runs bfloat16.

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;            // query rows per block (2 warpgroups x 64)
constexpr int BK = 64;             // keys per shared-memory stage
constexpr int WG = 128;            // threads per warpgroup
constexpr int THREADS = 3 * WG;    // consumers 0 and 1, producer 2
constexpr int PRODUCER_REGS = 40;  // 128 x 40 + 256 x 232 = 384 x 168
constexpr int CONSUMER_REGS = 232;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG = -1e30f;
constexpr int F32_ROWS = 8;        // query rows (warps) per float32 block

template <int D>
struct Tiles {
  static constexpr int STAGES = D == 256 ? 2 : 4;
  static constexpr int PANELS = D / 64;          // 64-column TMA boxes a row
  static constexpr int Q_PANEL = BQ * ROW_BYTES;  // bytes of one Q panel
  static constexpr int KV_PANEL = BK * ROW_BYTES;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K or V stage
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // + barriers (q; per stage: K full, V full, K empty, V empty) + slack to
  // align to 1 KiB
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   float* __restrict__ lse, const int* __restrict__ kv_len,
                   int sq, int sk_all, int h, int group, int causal,
                   int window, float scale_log2) {
  using T = Tiles<D>;
  constexpr int S = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;    // swizzle atoms: 1 KiB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + T::Q_BYTES;
  const uint32_t sV = sK + S * T::KV_BYTES;
  const uint32_t q_full = base + T::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + S + s); };
  auto empty_k = [&](int s) { return q_full + 8u * (1 + 2 * S + s); };
  auto empty_v = [&](int s) { return q_full + 8u * (1 + 3 * S + s); };

  // block order: the last query tile of every (batch, head) first; heads of
  // one KV head are neighbours
  const int bh = gridDim.x / ((sq + BQ - 1) / BQ);
  const int q0 = ((sq + BQ - 1) / BQ - 1 - static_cast<int>(blockIdx.x) / bh)
                 * BQ;
  const int bi = static_cast<int>(blockIdx.x) % bh / h;
  const int hi = static_cast<int>(blockIdx.x) % bh % h;
  const int kvh = hi / group;
  // this batch row's keys: [0, sk) (the wrapper keeps kv_len in [1, Sk])
  const int sk = kv_len != nullptr ? min(sk_all, kv_len[bi]) : sk_all;

  // key tiles with at least one live key for some query row of this tile
  const int k_hi = causal ? min(sk, min(sq, q0 + BQ)) : sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  // (at least one: where no key is live, one masked tile gives the rows 0)
  const int kb0 = k_lo / BK, kb1 = max(kb0 + 1, (k_hi + BK - 1) / BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty_k(s), 2 * WG);
      mbar_init(empty_v(s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int p = 0; p < T::PANELS; ++p)
        tma_load(sQ + p * T::Q_PANEL, &tq, q_full, p * 64, q0, hi, bi);
      for (int kb = kb0; kb < kb1; ++kb) {
        const int i = kb - kb0, s = i % S, n = i / S;
        if (n > 0) mbar_wait(empty_k(s), (n - 1) & 1);
        mbar_expect_tx(k_full(s), T::KV_BYTES);
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p)
          tma_load(sK + s * T::KV_BYTES + p * T::KV_PANEL, &tk, k_full(s),
                   p * 64, kb * BK, kvh, bi);
        if (n > 0) mbar_wait(empty_v(s), (n - 1) & 1);
        mbar_expect_tx(v_full(s), T::KV_BYTES);
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p)
          tma_load(sV + s * T::KV_BYTES + p * T::KV_PANEL, &tv, v_full(s),
                   p * 64, kb * BK, kvh, bi);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
    const int g = lane >> 2, tq = lane & 3;
    const int r0 = q0 + 64 * wg;                 // this warpgroup's rows
    const int r_last = min(r0 + 63, sq - 1);     // < r0: no live row
    const int row_a = r0 + 16 * warp + g;   // accumulator rows (see softmax)
    const int row_b = row_a + 8;
    const uint32_t qw = sQ + wg * 64 * ROW_BYTES;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};   // running max, log2 domain
    float l_r[2] = {0.f, 0.f};               // this thread's part of the sum

    // Per key tile j, in this warpgroup's turn on the tensor cores (named
    // barriers 3 and 4, taken in strict alternation): issue S_j = Q K_j^T
    // and O += P_{j-1} V_{j-1}, hand the turn over, then run the softmax of
    // S_j while P_{j-1} V_{j-1} is still in flight.  The first tile's S and
    // the last tile's P V are peeled off the loop: ptxas serializes wgmma
    // that is issued under a branch.
    auto sched_sync = [&] {
      asm volatile("bar.sync %0, %1;\n" :: "r"(3 + wg), "n"(2 * WG) : "memory");
    };
    auto sched_hand_over = [&] {
      asm volatile("bar.arrive %0, %1;\n" :: "r"(4 - wg), "n"(2 * WG)
                   : "memory");
    };
    auto issue_s = [&](float (&sc)[32], int s) {   // S = Q K^T, D / 16 steps
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;        // 16 bf16 of a panel
        wgmma_ss_n64(sc, smem_desc(qw + (ks / 4) * T::Q_PANEL + off, 16, 1024),
                     smem_desc(sK + s * T::KV_BYTES + (ks / 4) * T::KV_PANEL +
                               off, 16, 1024),
                     ks > 0);
      }
      wgmma_commit();
    };
    uint32_t pa[4][4];           // P_{j-1} in bf16: the A registers of P V
    float corr[2];               // rescales O before P_{j-1} V_{j-1} is added
    // O *= corr, then O += P V_{stage s}, once V has landed
    auto issue_pv = [&](int s, uint32_t par) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      mbar_wait(v_full(s), par);
      wgmma_fence();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_nd<D>(o, pa[kk],
                    smem_desc(sV + s * T::KV_BYTES + kk * 16 * ROW_BYTES,
                              T::KV_PANEL, 1024));
      wgmma_commit();
    };
    // online softmax of tile kb on its accumulator (element 4j + e is row
    // e < 2 ? row_a : row_b, key 64 kb + 8j + 2tq + (e & 1)); leaves P_kb
    // (float32) in sc and the factor for O in corr
    auto softmax = [&](float (&sc)[32], int kb) {
      const int c0 = kb * BK, c1 = c0 + BK - 1;
      if (c1 >= sk || (causal && c1 > r0) ||
          (window > 0 && c0 <= r_last - window)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? row_a : row_b;
            const int col = c0 + 8 * j + 2 * tq + (e & 1);
            bool ok = col < sk;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && col > row - window;
            if (!ok) sc[4 * j + e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {    // a row's 64 scores span a quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;    // no live key yet
        corr[r] = exp2_ftz(m_r[r] - mu[r]);
        m_r[r] = m_new;
        l_r[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p = exp2_ftz(fmaf(sc[j], scale_log2, -mu[(j >> 1) & 1]));
        sc[j] = p;
        l_r[(j >> 1) & 1] += p;
      }
    };
    // P in bf16: keys 16kk..16kk+15 of the accumulator are the A registers
    // of the kk-th k16 step of P V
    auto keep_p = [&](const float (&sc)[32]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      }
    };

    if (wg == 1) sched_hand_over();    // warpgroup 0 takes the first turn
    mbar_wait(q_full, 0);
    {                                  // tile kb0: S only
      float sc[32];
      mbar_wait(k_full(0), 0);
      sched_sync();
      issue_s(sc, 0);
      sched_hand_over();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(empty_k(0));
      softmax(sc, kb0);
      keep_p(sc);
    }
    for (int kb = kb0 + 1; kb < kb1; ++kb) {
      const int i = kb - kb0, s = i % S, sp = (i - 1) % S;
      const uint32_t par = (i / S) & 1, par_p = ((i - 1) / S) & 1;
      float sc[32];
      mbar_wait(k_full(s), par);
      sched_sync();
      issue_s(sc, s);
      issue_pv(sp, par_p);
      sched_hand_over();
      wgmma_wait<1>();                 // S_j is done; P_{j-1} V_{j-1} runs on
      fence_regs(sc);
      mbar_arrive(empty_k(s));
      softmax(sc, kb);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty_v(sp));
      keep_p(sc);
    }
    {                                  // the last tile's P V
      const int i = kb1 - 1 - kb0;
      issue_pv(i % S, (i / S) & 1);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty_v(i % S));
    }

    if (r_last < r0) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    // the rows' log-sum-exp of the scaled scores (natural log) for K4b:
    // 2^m l is the sum of 2^(scale log2(e) s); a row with no live key gets
    // +inf, for which exp(s - lse) is 0.  The quad's first thread writes.
    if (lse != nullptr && tq == 0) {
      float* lr = lse + (static_cast<int64_t>(bi) * h + hi) * sq;
      if (row_a < sq)
        lr[row_a] = m_r[0] == -INFINITY ? INFINITY
                                        : (m_r[0] + log2f(l_r[0])) * LN2;
      if (row_b < sq)
        lr[row_b] = m_r[1] == -INFINITY ? INFINITY
                                        : (m_r[1] + log2f(l_r[1])) * LN2;
    }
    const float inv_a = 1.f / fmaxf(l_r[0], 1e-30f);
    const float inv_b = 1.f / fmaxf(l_r[1], 1e-30f);
    // O into this warpgroup's rows of Q's shared memory, in the same
    // 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8)
    unsigned char* ow = smem + wg * 64 * ROW_BYTES +
                        (16 * warp + g) * ROW_BYTES + 4 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* p = ow + (j / 8) * T::Q_PANEL + ((j % 8) ^ g) * 16;
      *reinterpret_cast<uint32_t*>(p) =
          pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(p + 8 * ROW_BYTES) =
          pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(WG) : "memory");
    if (t == 0) {
#pragma unroll
      for (int p = 0; p < T::PANELS; ++p)
        tma_store(&to, qw + p * T::Q_PANEL, p * 64, r0, hi, bi);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, const int* __restrict__ kv_len,
                  int sq, int sk_all, int h, int group, Strides qs,
                  Strides ks, Strides vs, int causal, int window,
                  float scale) {
  constexpr int R = D / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * F32_ROWS + threadIdx.x / 32;
  if (i >= sq) return;
  const int64_t bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int kvh = hi / group;
  const int sk = kv_len != nullptr ? min(sk_all, kv_len[bi]) : sk_all;
  const float* qp = q + bi * qs.b + static_cast<int64_t>(i) * qs.s + hi * qs.h;
  float qr[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qr[r] = qp[lane + 32 * r] * scale;
    acc[r] = 0.f;
  }
  const int lo = window > 0 ? max(0, i - window + 1) : 0;
  const int hi_k = causal ? min(sk, i + 1) : sk;
  float m = NEG, l = 0.f;
  for (int j = lo; j < hi_k; ++j) {
    const float* kp = k + bi * ks.b + static_cast<int64_t>(j) * ks.s + kvh * ks.h;
    const float* vp = v + bi * vs.b + static_cast<int64_t>(j) * vs.s + kvh * vs.h;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) s = fmaf(qr[r], kp[lane + 32 * r], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = acc[r] * corr + p * vp[lane + 32 * r];
    m = m_new;
  }
  float* op = o + ((bi * sq + i) * static_cast<int64_t>(h) + hi) * D;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int r = 0; r < R; ++r) op[lane + 32 * r] = acc[r] / den;
  if (lse != nullptr && lane == 0)   // as the bfloat16 kernel writes it
    lse[(bi * h + hi) * sq + i] = l > 0.f ? m + logf(l) : INFINITY;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, const int* kv_len, int b, int sq, int sk, int h,
                int kvh, Strides qs, Strides ks, Strides vs, int causal,
                int window, cudaStream_t stream) {
  using T = Tiles<D>;
  const int64_t blocks = static_cast<int64_t>((sq + BQ - 1) / BQ) * b * h;
  if (blocks > INT_MAX) return -1;
  const Strides os{static_cast<int64_t>(sq) * h * D,
                   static_cast<int64_t>(h) * D, D};
  // set on every launch: the limit belongs to the device that is current.
  // First, too: a runtime call binds the device's context to the calling
  // thread, which cuTensorMapEncodeTiled below needs.
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap mq, mk, mv, mo;
  if (!tensor_map(&mq, q, D, sq, h, b, qs, BQ) ||
      !tensor_map(&mk, k, D, sk, kvh, b, ks, BK) ||
      !tensor_map(&mv, v, D, sk, kvh, b, vs, BK) ||
      !tensor_map(&mo, o, D, sq, h, b, os, 64))
    return -2;
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  flash_fwd_bf16<D><<<static_cast<int>(blocks), THREADS, T::SMEM, stream>>>(
      mq, mk, mv, mo, lse, kv_len, sq, sk, h, h / kvh, causal, window,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const int* kv_len, int b, int sq, int sk, int h,
               int kvh, Strides qs, Strides ks, Strides vs, int causal,
               int window, cudaStream_t stream) {
  const dim3 grid((sq + F32_ROWS - 1) / F32_ROWS, b * h);
  flash_fwd_f32<D><<<grid, F32_ROWS * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, kv_len, sq,
      sk, h, h / kvh, qs, ks, vs, causal, window,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o (B, Sq, H, D) contiguous; q, k, v by strides (elements).  lse, when
// not null, float32 (B, H, Sq) contiguous, receives each row's log-sum-exp
// of the scaled scores (+inf for a row with no live key); K4b reads it.
// kv_len, when not null, int32 (B,) with every value in [1, Sk], cuts batch
// row b's keys to [0, kv_len[b]).  dtype 0 is bfloat16, 1 is float32.
// Returns the cudaError of the launch, -1 for a head_dim, dtype or grid the kernel does not take, or -2 when a
// bfloat16 tensor map cannot be built (the driver lacks
// cuTensorMapEncodeTiled or refuses the strides).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* kv_len, int64_t b,
    int64_t sq, int64_t sk, int64_t h, int64_t kvh, int64_t d, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int dtype, int causal, int window,
    void* stream) {
  if (b * h > 65535 || sq > (1 << 30) || sk > (1 << 30) || kvh <= 0 ||
      h % kvh)
    return -1;
  if (b == 0 || sq == 0) return 0;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const int w = window > 0 ? window : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ib = static_cast<int>(b), isq = static_cast<int>(sq),
            isk = static_cast<int>(sk), ih = static_cast<int>(h),
            ikv = static_cast<int>(kvh);
#define REPRO_FA_CASE(DIM)                                                    \
  case DIM:                                                                   \
    return dtype == 0 ? launch_bf16<DIM>(q, k, v, o, lse, kv_len, ib, isq,    \
                                         isk, ih, ikv, qs, ks, vs, causal, w, \
                                         st)                                  \
                      : launch_f32<DIM>(q, k, v, o, lse, kv_len, ib, isq,     \
                                        isk, ih, ikv, qs, ks, vs, causal, w,  \
                                        st);
  if (dtype != 0 && dtype != 1) return -1;
  switch (d) {
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(128)
    REPRO_FA_CASE(256)
    default:
      return -1;
  }
#undef REPRO_FA_CASE
}

// Dynamic shared memory of one bfloat16 block at head_dim d, or -1.
extern "C" int repro_flash_attention_smem(int64_t d) {
  return d == 64 ? Tiles<64>::SMEM : d == 128 ? Tiles<128>::SMEM
       : d == 256 ? Tiles<256>::SMEM : -1;
}
