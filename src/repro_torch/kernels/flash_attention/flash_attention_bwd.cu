// K4b: the backward of flash attention (K4), for sm_90a, by recompute.
//
// The TPU package has no backward kernel: its models train through plain
// blockwise_attention (src/repro/models/attention.py:94), which XLA
// differentiates.  The port's forward runs on K4, so its gradient is this
// kernel.  It computes the gradients of what flash_attention_ref computes
// (scale 1/sqrt(D), absolute positions from 0, causal keeps j <= i, window
// > 0 keeps j > i - window, a fully masked row gives 0) without storing the
// scores: with P = exp(S - lse) recomputed tile by tile,
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),  Delta_i = dO_i . O_i,
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D).
// Inputs q, o, dO (B, Sq, H, D) and k, v (B, Sk, KV, D), contiguous; query
// head h reads KV head h / (H / KV).  bfloat16 or float32, D 64, 128 or 256;
// every sum is float32.
//
// bfloat16 (the model's dtype), on the tensor cores, three kernels in
// stream order.  Tiles are 64 query rows by 64 keys; a block has 8 warps;
// products are mma.sync.m16n8k16 (bf16 in, float32 sums) on ldmatrix
// fragments of shared-memory tiles whose rows are padded by 16 bytes (an
// 8-row ldmatrix meets each bank once); P and dS are rounded to bfloat16
// before their products, as the forward rounds P.
//  * dq_mma_kernel, a block per (query tile, head, batch): Delta of its
//    rows from O and dO; a first pass over the key tiles the rows can see
//    gives each row's max and sum, so lse (K4's forward is left as it is
//    and does not write lse out); a second pass recomputes S and dP, forms
//    dS in shared memory and adds dS K to dQ, held in registers.  Writes
//    dQ, and lse and Delta (float32, (B, H, Sq)) for dkv_mma_kernel.
//  * dkv_mma_kernel, a block per (key tile, KV head, batch, split): K and
//    V of the tile stay in shared memory while the block walks its share of
//    the (query head of the group, query tile) steps that can see the tile
//    (causal: from the tile on; window: up to W - 1 past its end),
//    computing S^T and dP^T and adding P^T dO to dV and dS^T Q to dK in
//    registers.  The steps are split evenly among `splits` blocks (the
//    launcher picks enough for about two blocks per SM, at most 8: at
//    gemma3-1b's train shape a layer has only 64 key tiles), each writing
//    float32 partial sums into a scratch buffer of
//    repro_flash_attention_bwd_workspace floats.
//  * reduce_kernel adds the splits' partial sums in split order and rounds
//    dK and dV to bfloat16.  The G query heads of a KV group meet inside the
//    blocks and the splits in a fixed order: no atomics, and the result is
//    the same on every run.
// Each block brings its next tile in by cp.async while it computes on the
// current one (two buffers).
//
// float32 (tests and small configurations), on the CUDA cores: the same
// two passes with tiles of 16 query rows by 32 keys (dq_kernel, dkv_kernel;
// a warp computes 2 rows x 32 keys of S and dP, a thread one key and two
// rows), one block per key tile, dK and dV written directly.
//
// Key tiles that the masks remove for a whole query tile, and query tiles
// that cannot see a key tile, are never visited.
//
// What bounds it on the H100: operations, 10 D per live (query, key) pair
// (plus 2 D for the lse pass), against the bytes of q, k, v, o, dO and the
// three gradients.  mma.sync takes its operands through registers, and at
// 16 x 32 warp tiles the ldmatrix traffic holds it well below the
// tensor-core peak; wgmma on shared-memory operands, TMA loads and lse
// from K4's epilogue are a later PR.
//
// Built with -DREPRO_K4B_PLANTED_FAULTS, the library is instead the
// variant that the checks hold to fail (repro_flash_attention_bwd_planted):
// fault 1 drops one key tile from the dK/dV work (its dK, dV rows stay 0),
// fault 2 leaves Delta out of dS.  The shipped library has neither.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 16;             // query rows per tile: warp w has w, w + 8
constexpr int BK = 32;             // keys per tile: one per lane

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;
  float* delta;
  float* part;       // bfloat16 path: dK, dV partial sums, 2 x splits x dk
  int64_t b, sq, sk, h, kv;
  int causal, window, splits;
  float scale;
#ifdef REPRO_K4B_PLANTED_FAULTS
  int fault;
  int64_t fault_tile;  // key tile that fault 1 drops; -1: the last
#endif
};

#ifdef REPRO_K4B_PLANTED_FAULTS
// the dK/dV grid's x is the key tile
__device__ __forceinline__ bool tile_dropped(const Args& a, int64_t kt) {
  return a.fault == 1 &&
         kt == (a.fault_tile < 0 ? gridDim.x - 1 : a.fault_tile);
}
__device__ __forceinline__ bool delta_dropped(const Args& a) {
  return a.fault == 2;
}
#else
__device__ __forceinline__ bool tile_dropped(const Args&, int64_t) {
  return false;
}
__device__ __forceinline__ bool delta_dropped(const Args&) { return false; }
#endif

__device__ __forceinline__ bool live(const Args& a, int64_t i, int64_t j) {
  return i < a.sq && j < a.sk && (!a.causal || j <= i) &&
         (a.window <= 0 || j > i - a.window);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m; m >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
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

// the S part of dots alone (the lse pass)
template <int D>
__device__ __forceinline__ void dots_s(const float* Qs, const float* Ks,
                                       int w, int lane, float s[2]) {
  s[0] = s[1] = 0.f;
  const float* kr = Ks + lane * (D + 1);
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 q0 = *reinterpret_cast<const float4*>(Qs + w * D + d);
    float4 q1 = *reinterpret_cast<const float4*>(Qs + (w + 8) * D + d);
    float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
    s[0] += q0.x * k0 + q0.y * k1 + q0.z * k2 + q0.w * k3;
    s[1] += q1.x * k0 + q1.y * k1 + q1.z * k2 + q1.w * k3;
  }
}

// key tiles [lo, hi) that query rows [q0, q0 + BQ) can see
__device__ __forceinline__ void key_tiles(const Args& a, int64_t q0,
                                          int64_t& lo, int64_t& hi) {
  int64_t kmin = a.window > 0 ? q0 - a.window + 1 : 0;
  int64_t kmax = a.causal ? q0 + BQ : a.sk;        // exclusive
  if (kmin < 0) kmin = 0;
  if (kmax > a.sk) kmax = a.sk;
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

  // Delta of rows w and w + 8
  float dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int64_t row = q0 + w + 8 * r;
    float acc = 0.f;
    if (row < a.sq)
      for (int d = lane; d < D; d += 32)
        acc += dout[(row * a.h + hh) * D + d] * o[(row * a.h + hh) * D + d];
    dl[r] = delta_dropped(a) ? 0.f : warp_sum(acc);
  }

  int64_t kt_lo, kt_hi;
  key_tiles(a, q0, kt_lo, kt_hi);

  // pass 1: lse of rows w and w + 8 (online max and sum)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int64_t kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();
    load_rows<D>(Ks, D + 1, k, kt * BK, BK, a.sk, a.kv, kvh);
    __syncthreads();
    float s[2];
    dots_s<D>(Qs, Ks, w, lane, s);
    const int64_t j = kt * BK + lane;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = live(a, q0 + w + 8 * r, j) ? s[r] * a.scale : -INFINITY;
      float mt = warp_max(x);
      float mn = fmaxf(m[r], mt);
      if (mn == -INFINITY) continue;             // nothing live yet
      float e = warp_sum(x == -INFINITY ? 0.f : __expf(x - mn));
      l[r] = l[r] * __expf(m[r] - mn) + e;
      m[r] = mn;
    }
  }
  float lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a row with no live key: P = exp(s - inf) = 0 everywhere
    lse[r] = l[r] > 0.f ? m[r] + __logf(l[r]) : INFINITY;
    int64_t row = q0 + w + 8 * r;
    if (lane == 0 && row < a.sq) {
      a.lse[(bb * a.h + hh) * a.sq + row] = lse[r];
      a.delta[(bb * a.h + hh) * a.sq + row] = dl[r];
    }
  }

  // pass 2: dQ[i][d] += sum_j dS[i][j] K[j][d]; a thread owns column
  // d = tid % D of rows [ib * RN, ib * RN + RN)
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
      float p = live(a, q0 + w + 8 * r, j) ? __expf(s[r] * a.scale - lse[r])
                                           : 0.f;
      dSs[(w + 8 * r) * BK + lane] = p * (dp[r] - dl[r]);
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

  // query tiles that can see keys [k0, k0 + BK)
  int64_t qmin = a.causal ? k0 : 0;
  int64_t qmax = a.sq;                                   // exclusive
  if (a.window > 0 && k0 + BK - 1 + a.window < qmax)
    qmax = k0 + BK - 1 + a.window;
  int64_t qt_lo = qmin / BQ, qt_hi = qmax > qmin ? (qmax + BQ - 1) / BQ : 0;
  if (tile_dropped(a, kt)) qt_hi = 0;

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
        lse_s[threadIdx.x] = row < a.sq ? lse[hh * a.sq + row] : INFINITY;
        dl_s[threadIdx.x] = row < a.sq ? delta[hh * a.sq + row] : 0.f;
      }
      __syncthreads();
      float s[2], dp[2];
      dots<D>(Qs, dOs, Ks, Vs, w, lane, s, dp);
      const int64_t j = k0 + lane;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int ri = w + 8 * r;
        float p = live(a, q0 + ri, j) ? __expf(s[r] * a.scale - lse_s[ri])
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

// ------------------------------------------- bfloat16: mma.sync tiles
// In each tile step a warp first computes a 16 x 32 piece of S and dP
// (rows w % 4, columns w / 4), forms P and dS in float32 and writes them to
// shared memory as bfloat16; after a barrier it multiplies them into its
// own 16 x D/2 piece of the gradient (rows w % 4, columns w / 4 of D),
// which stays in registers.
constexpr int MT = 64;             // query rows and keys per tile
constexpr int LDP = MT + 8;        // row stride of the P / dS tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand, 16 x 16 at (r0, c0) of a row-major tile with row stride ld
__device__ __forceinline__ void load_a(uint32_t a[4],
                                       const __nv_bfloat16* t, int ld,
                                       int r0, int c0, int lane) {
  ldsm4(a, t + (r0 + (lane % 16)) * ld + c0 + (lane / 16) * 8);
}
// B operands of two n-tiles (n0 .. n0 + 15) at k0 .. k0 + 15 from a tile
// stored [n][k] row-major: b[0], b[1] for n0, b[2], b[3] for n0 + 8
__device__ __forceinline__ void load_b_nk(uint32_t b[4],
                                          const __nv_bfloat16* t, int ld,
                                          int n0, int k0, int lane) {
  int j = lane / 8;
  ldsm4(b, t + (n0 + (lane % 8) + (j / 2) * 8) * ld + k0 + (j % 2) * 8);
}
// the same from a tile stored [k][n] row-major (transposed on load)
__device__ __forceinline__ void load_b_kn(uint32_t b[4],
                                          const __nv_bfloat16* t, int ld,
                                          int k0, int n0, int lane) {
  int j = lane / 8;
  ldsm4t(b, t + (k0 + (lane % 8) + (j % 2) * 8) * ld + n0 + (j / 2) * 8);
}

// 64 rows from row0 of a (rows, heads, D) bfloat16 slab at head hh into a
// tile of row stride D + 8, 16 bytes a thread; rows past limit are 0
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t row0, int64_t limit,
                                          int64_t heads, int64_t hh) {
  constexpr int CH = D / 8;                       // 16-byte chunks a row
  for (int c = threadIdx.x; c < MT * CH; c += THREADS) {
    int r = c / CH, k = c % CH;
    int64_t row = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < limit)
      v = *reinterpret_cast<const uint4*>(src + (row * heads + hh) * D +
                                          k * 8);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + k * 8) = v;
  }
}

// load_tile by cp.async (16 bytes a thread, rows past limit zero-filled);
// the caller commits the group and waits for it
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int64_t row0, int64_t limit,
                                                int64_t heads, int64_t hh) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < MT * CH; c += THREADS) {
    int r = c / CH, k = c % CH;
    int64_t row = row0 + r;
    const bool ok = row < limit;
    const __nv_bfloat16* from = src + ((ok ? row : 0) * heads + hh) * D + k * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst + r * (D + 8) + k * 8)), "l"(from),
                    "r"(ok ? 16 : 0));
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// acc (16 x 32: four n-tiles) += A rows [r0, r0 + 16) of ta times the
// rows [n0, n0 + 32) of tb, both [row][d] tiles of width D
template <int D>
__device__ __forceinline__ void mma_rows(float acc[4][4],
                                         const __nv_bfloat16* ta, int r0,
                                         const __nv_bfloat16* tb, int n0,
                                         int lane) {
#pragma unroll 4
  for (int ks = 0; ks < D; ks += 16) {
    uint32_t a[4], b0[4], b1[4];
    load_a(a, ta, D + 8, r0, ks, lane);
    load_b_nk(b0, tb, D + 8, n0, ks, lane);
    load_b_nk(b1, tb, D + 8, n0 + 16, ks, lane);
    mma16816(acc[0], a, b0[0], b0[1]);
    mma16816(acc[1], a, b0[2], b0[3]);
    mma16816(acc[2], a, b1[0], b1[1]);
    mma16816(acc[3], a, b1[2], b1[3]);
  }
}

template <int N>
__device__ __forceinline__ void zero4(float acc[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// acc (16 x D/2: D/16 n-tiles) += the 16 x 64 tile rows [r0, r0 + 16) of
// tp (row stride LDP) times the 64 x D/2 columns [c0, c0 + D/2) of tv, a
// [k][d] tile of width D
template <int D>
__device__ __forceinline__ void mma_into(float acc[][4],
                                         const __nv_bfloat16* tp, int r0,
                                         const __nv_bfloat16* tv, int c0,
                                         int lane) {
#pragma unroll
  for (int ks = 0; ks < MT; ks += 16) {
    uint32_t a[4];
    load_a(a, tp, LDP, r0, ks, lane);
#pragma unroll
    for (int nt = 0; nt < D / 16; nt += 2) {
      uint32_t b[4];
      load_b_kn(b, tv, D + 8, ks, c0 + nt * 8, lane);
      mma16816(acc[nt], a, b[0], b[1]);
      mma16816(acc[nt + 1], a, b[2], b[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dq_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using bf = __nv_bfloat16;
  constexpr int TILE = MT * (D + 8);
  bf* Qs = reinterpret_cast<bf*>(smem_raw);          // MT x (D + 8)
  bf* dOs = Qs + TILE;
  bf* Kb = dOs + TILE;                               // two K tiles
  bf* Vb = Kb + 2 * TILE;                            // two V tiles
  bf* dSs = Vb + 2 * TILE;                           // MT x LDP
  float* stat = reinterpret_cast<float*>(dSs + MT * LDP);  // 2 x 2 x MT
  float* lse_s = stat + 4 * MT;                      // MT
  float* dl_s = lse_s + MT;                          // MT

  const int64_t n_qt = (a.sq + MT - 1) / MT;
  const int64_t qt = a.causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int64_t hh = blockIdx.y, bb = blockIdx.z;
  const int64_t kvh = hh / (a.h / a.kv);
  const int64_t q0 = qt * MT;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = (w % 4) * 16;                       // the warp's rows
  const int kh = (w / 4) * 32;                       // its key half
  const int dh = (w / 4) * (D / 2);                  // its half of D

  const bf* q = static_cast<const bf*>(a.q) + bb * a.sq * a.h * D;
  const bf* o = static_cast<const bf*>(a.o) + bb * a.sq * a.h * D;
  const bf* dout = static_cast<const bf*>(a.dout) + bb * a.sq * a.h * D;
  const bf* k = static_cast<const bf*>(a.k) + bb * a.sk * a.kv * D;
  const bf* v = static_cast<const bf*>(a.v) + bb * a.sk * a.kv * D;

  load_tile_async<D>(Qs, q, q0, a.sq, a.h, hh);
  load_tile_async<D>(dOs, dout, q0, a.sq, a.h, hh);
  cp_commit();
  // Delta: warp w takes rows 8w .. 8w + 7
  for (int r = w * 8; r < w * 8 + 8; ++r) {
    int64_t row = q0 + r;
    float acc = 0.f;
    if (row < a.sq)
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(dout[(row * a.h + hh) * D + d]) *
               __bfloat162float(o[(row * a.h + hh) * D + d]);
    acc = warp_sum(acc);
    if (lane == 0) dl_s[r] = delta_dropped(a) ? 0.f : acc;
  }

  int64_t kt_lo, kt_hi;
  {
    int64_t kmin = a.window > 0 ? q0 - a.window + 1 : 0;
    int64_t kmax = a.causal ? q0 + MT : a.sk;
    if (kmin < 0) kmin = 0;
    if (kmax > a.sk) kmax = a.sk;
    kt_lo = kmin / MT;
    kt_hi = kmax > kmin ? (kmax + MT - 1) / MT : kt_lo;
  }

  // pass 1: each thread's rows rg + g and rg + g + 8 over its key half.
  // K tiles come in by cp.async, the next one in flight while this one is
  // used (two buffers)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (kt_lo < kt_hi) {
    load_tile_async<D>(Kb, k, kt_lo * MT, a.sk, a.kv, kvh);
    cp_commit();
  }
  for (int64_t kt = kt_lo; kt < kt_hi; ++kt) {
    const bf* Ks = Kb + ((kt - kt_lo) & 1) * TILE;
    if (kt + 1 < kt_hi) {
      load_tile_async<D>(Kb + ((kt + 1 - kt_lo) & 1) * TILE, k,
                         (kt + 1) * MT, a.sk, a.kv, kvh);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[4][4];
    zero4<4>(s);
    mma_rows<D>(s, Qs, rg, Ks, kh, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t i = q0 + rg + g + 8 * r;
      float x[8], mt = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int64_t j = kt * MT + kh + nt * 8 + 2 * t + e;
          float val = live(a, i, j) ? s[nt][2 * r + e] * a.scale : -INFINITY;
          x[nt * 2 + e] = val;
          mt = fmaxf(mt, val);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      // no branch around the shuffles: quads of one warp hold other rows
      const float mn = fmaxf(m[r], mt);
      const float mref = mn == -INFINITY ? 0.f : mn;
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) e += __expf(x[c] - mref);
      e += __shfl_xor_sync(0xffffffffu, e, 1);
      e += __shfl_xor_sync(0xffffffffu, e, 2);
      l[r] = l[r] * __expf(m[r] - mref) + e;
      m[r] = mn;
    }
    __syncthreads();                 // before the next load reuses Ks
  }
  cp_wait<0>();                      // Q and dO when no key tile came
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      stat[(w / 4) * 2 * MT + rg + g + 8 * r] = m[r];
      stat[(w / 4) * 2 * MT + MT + rg + g + 8 * r] = l[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < MT) {
    const int r = threadIdx.x;
    float m0 = stat[r], l0 = stat[MT + r];
    float m1 = stat[2 * MT + r], l1 = stat[3 * MT + r];
    float mx = fmaxf(m0, m1), ls = 0.f;
    if (mx != -INFINITY)
      ls = (l0 > 0.f ? l0 * __expf(m0 - mx) : 0.f) +
           (l1 > 0.f ? l1 * __expf(m1 - mx) : 0.f);
    float lse = ls > 0.f ? mx + __logf(ls) : INFINITY;
    lse_s[r] = lse;
    int64_t row = q0 + r;
    if (row < a.sq) {
      a.lse[(bb * a.h + hh) * a.sq + row] = lse;
      a.delta[(bb * a.h + hh) * a.sq + row] = dl_s[r];
    }
  }
  __syncthreads();

  // pass 2: dQ (rows rg, columns dh .. dh + D/2) += dS K
  float acc[D / 16][4];
  zero4<D / 16>(acc);
  if (kt_lo < kt_hi) {
    load_tile_async<D>(Kb, k, kt_lo * MT, a.sk, a.kv, kvh);
    load_tile_async<D>(Vb, v, kt_lo * MT, a.sk, a.kv, kvh);
    cp_commit();
  }
  for (int64_t kt = kt_lo; kt < kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    const bf* Ks = Kb + buf * TILE;
    const bf* Vs = Vb + buf * TILE;
    if (kt + 1 < kt_hi) {
      load_tile_async<D>(Kb + (buf ^ 1) * TILE, k, (kt + 1) * MT, a.sk,
                         a.kv, kvh);
      load_tile_async<D>(Vb + (buf ^ 1) * TILE, v, (kt + 1) * MT, a.sk,
                         a.kv, kvh);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    zero4<4>(s);
    zero4<4>(dp);
    mma_rows<D>(s, Qs, rg, Ks, kh, lane);
    mma_rows<D>(dp, dOs, rg, Vs, kh, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ri = rg + g + 8 * r;
      const float lse = lse_s[ri], dl = dl_s[ri];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int64_t j = kt * MT + kh + nt * 8 + 2 * t + e;
          float p = live(a, q0 + ri, j)
                        ? __expf(s[nt][2 * r + e] * a.scale - lse) : 0.f;
          ds[e] = p * (dp[nt][2 * r + e] - dl);
        }
        *reinterpret_cast<uint32_t*>(dSs + ri * LDP + kh + nt * 8 + 2 * t) =
            pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();
    mma_into<D>(acc, dSs, rg, Ks, dh, lane);
    __syncthreads();                 // before the next load reuses Ks, Vs
  }
  bf* dq = static_cast<bf*>(a.dq) + bb * a.sq * a.h * D;
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int64_t row = q0 + rg + g + 8 * r;
      if (row < a.sq)
        *reinterpret_cast<uint32_t*>(dq + (row * a.h + hh) * D + dh +
                                     nt * 8 + 2 * t) =
            pack_bf16(acc[nt][2 * r] * a.scale, acc[nt][2 * r + 1] * a.scale);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dkv_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using bf = __nv_bfloat16;
  constexpr int TILE = MT * (D + 8);
  bf* Ks = reinterpret_cast<bf*>(smem_raw);          // MT x (D + 8)
  bf* Vs = Ks + TILE;
  bf* Qb = Vs + TILE;                                // two Q tiles
  bf* dOb = Qb + 2 * TILE;                           // two dO tiles
  bf* Ps = dOb + 2 * TILE;                           // MT keys x LDP
  bf* dSs = Ps + MT * LDP;
  float* lse_b = reinterpret_cast<float*>(dSs + MT * LDP);   // 2 x MT
  float* dl_b = lse_b + 2 * MT;                               // 2 x MT

  const int64_t kt = blockIdx.x;
  const int64_t kvh = blockIdx.y;
  const int64_t bb = blockIdx.z / a.splits, sp = blockIdx.z % a.splits;
  const int64_t g_heads = a.h / a.kv;
  const int64_t k0 = kt * MT;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kg = (w % 4) * 16;                       // the warp's keys
  const int qh = (w / 4) * 32;                       // its query half
  const int dh = (w / 4) * (D / 2);                  // its half of D

  const bf* q = static_cast<const bf*>(a.q) + bb * a.sq * a.h * D;
  const bf* dout = static_cast<const bf*>(a.dout) + bb * a.sq * a.h * D;
  const bf* k = static_cast<const bf*>(a.k) + bb * a.sk * a.kv * D;
  const bf* v = static_cast<const bf*>(a.v) + bb * a.sk * a.kv * D;
  const float* lse = a.lse + bb * a.h * a.sq;
  const float* delta = a.delta + bb * a.h * a.sq;

  load_tile_async<D>(Ks, k, k0, a.sk, a.kv, kvh);
  load_tile_async<D>(Vs, v, k0, a.sk, a.kv, kvh);
  cp_commit();

  int64_t qmin = a.causal ? k0 : 0;
  int64_t qmax = a.sq;
  if (a.window > 0 && k0 + MT - 1 + a.window < qmax)
    qmax = k0 + MT - 1 + a.window;
  int64_t qt_lo = qmin / MT, qt_hi = qmax > qmin ? (qmax + MT - 1) / MT : 0;
  if (tile_dropped(a, kt)) qt_hi = 0;

  float dk[D / 16][4], dv[D / 16][4];
  zero4<D / 16>(dk);
  zero4<D / 16>(dv);
  // the (head, query tile) steps of this key tile, split evenly among
  // a.splits blocks; each writes partial sums that reduce_kernel adds
  const int64_t n_q = qt_hi > qt_lo ? qt_hi - qt_lo : 0;
  const int64_t total = g_heads * n_q;
  const int64_t it_lo = total * sp / a.splits;
  const int64_t it_hi = total * (sp + 1) / a.splits;
  // step it's Q and dO tiles (cp.async) and lse and Delta into buffer buf
  auto fetch = [&](int64_t it, int buf) {
    const int64_t hh = kvh * g_heads + it / n_q;
    const int64_t q0 = (qt_lo + it % n_q) * MT;
    load_tile_async<D>(Qb + buf * TILE, q, q0, a.sq, a.h, hh);
    load_tile_async<D>(dOb + buf * TILE, dout, q0, a.sq, a.h, hh);
    cp_commit();
    if (threadIdx.x < MT) {
      int64_t row = q0 + threadIdx.x;
      lse_b[buf * MT + threadIdx.x] =
          row < a.sq ? lse[hh * a.sq + row] : INFINITY;
      dl_b[buf * MT + threadIdx.x] = row < a.sq ? delta[hh * a.sq + row]
                                                : 0.f;
    }
  };
  if (it_lo < it_hi) fetch(it_lo, 0);
  for (int64_t it = it_lo; it < it_hi; ++it) {
    const int buf = (it - it_lo) & 1;
    const int64_t q0 = (qt_lo + it % n_q) * MT;
    const bf* Qs = Qb + buf * TILE;
    const bf* dOs = dOb + buf * TILE;
    const float* lse_s = lse_b + buf * MT;
    const float* dl_s = dl_b + buf * MT;
    if (it + 1 < it_hi) {
      fetch(it + 1, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // S^T and dP^T: keys kg .. kg + 15 x queries qh .. qh + 31
    float s[4][4], dp[4][4];
    zero4<4>(s);
    zero4<4>(dp);
    mma_rows<D>(s, Ks, kg, Qs, qh, lane);
    mma_rows<D>(dp, Vs, kg, dOs, qh, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = kg + g + 8 * r;
      const int64_t j = k0 + kr;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = qh + nt * 8 + 2 * t + e;
          p[e] = live(a, q0 + qc, j)
                     ? __expf(s[nt][2 * r + e] * a.scale - lse_s[qc]) : 0.f;
          ds[e] = p[e] * (dp[nt][2 * r + e] - dl_s[qc]);
        }
        *reinterpret_cast<uint32_t*>(Ps + kr * LDP + qh + nt * 8 + 2 * t) =
            pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dSs + kr * LDP + qh + nt * 8 + 2 * t) =
            pack_bf16(ds[0], ds[1]);
      }
    }
    __syncthreads();
    mma_into<D>(dv, Ps, kg, dOs, dh, lane);
    mma_into<D>(dk, dSs, kg, Qs, dh, lane);
    __syncthreads();                 // before the next fetch reuses buf
  }
  cp_wait<0>();
  const int64_t n_el = a.b * a.sk * a.kv * D;
  float* pk = a.part + sp * n_el + bb * a.sk * a.kv * D;
  float* pv = pk + a.splits * n_el;
#pragma unroll
  for (int nt = 0; nt < D / 16; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int64_t key = k0 + kg + g + 8 * r;
      if (key < a.sk) {
        int64_t off = (key * a.kv + kvh) * D + dh + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(pk + off) =
            make_float2(dk[nt][2 * r], dk[nt][2 * r + 1]);
        *reinterpret_cast<float2*>(pv + off) =
            make_float2(dv[nt][2 * r], dv[nt][2 * r + 1]);
      }
    }
}

// dK = scale * (the splits' dK partials added in split order), dV the
// same without the scale; two elements a thread, bfloat16 out
__global__ void __launch_bounds__(THREADS)
reduce_kernel(Args a, int64_t n_el) {
  const int64_t pairs = n_el / 2;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(THREADS) + threadIdx.x;
       i < pairs; i += static_cast<int64_t>(gridDim.x) * THREADS) {
    float2 k = make_float2(0.f, 0.f), v = make_float2(0.f, 0.f);
    for (int sp = 0; sp < a.splits; ++sp) {
      float2 pk = reinterpret_cast<const float2*>(a.part + sp * n_el)[i];
      float2 pv = reinterpret_cast<const float2*>(
          a.part + (a.splits + sp) * n_el)[i];
      k.x += pk.x; k.y += pk.y; v.x += pv.x; v.y += pv.y;
    }
    reinterpret_cast<uint32_t*>(a.dk)[i] = pack_bf16(k.x * a.scale,
                                                     k.y * a.scale);
    reinterpret_cast<uint32_t*>(a.dv)[i] = pack_bf16(v.x, v.y);
  }
}

template <int D>
constexpr int dq_mma_smem() {
  return 6 * MT * (D + 8) * 2 + MT * LDP * 2 + 6 * MT * 4;
}
template <int D>
constexpr int dkv_mma_smem() {
  return 6 * MT * (D + 8) * 2 + 2 * MT * LDP * 2 + 4 * MT * 4;
}

template <int D>
int launch_mma(const Args& a, cudaStream_t stream) {
  cudaError_t err;
  err = cudaFuncSetAttribute(dq_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_mma_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_mma_smem<D>());
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 gq(static_cast<unsigned>((a.sq + MT - 1) / MT),
          static_cast<unsigned>(a.h), static_cast<unsigned>(a.b));
  dq_mma_kernel<D><<<gq, THREADS, dq_mma_smem<D>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 gk(static_cast<unsigned>((a.sk + MT - 1) / MT),
          static_cast<unsigned>(a.kv),
          static_cast<unsigned>(a.b * a.splits));
  dkv_mma_kernel<D><<<gk, THREADS, dkv_mma_smem<D>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_el = a.b * a.sk * a.kv * D;
  int64_t blocks = (n_el / 2 + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  reduce_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a,
                                                                       n_el);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
constexpr int dq_smem() {
  return (2 * BQ * D + 2 * BK * (D + 1) + BQ * BK) * 4;
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

int launch_bf16(const Args& a, int64_t d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_mma<64>(a, stream);
    case 128: return launch_mma<128>(a, stream);
    case 256: return launch_mma<256>(a, stream);
    default: return -1;
  }
}

// blocks that share one key tile's dK/dV work in the bfloat16 kernel:
// enough for about two blocks per SM of the current device, at most 8
int dkv_splits(int64_t b, int64_t sk, int64_t kv, int* splits) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t base = (sk + MT - 1) / MT * kv * b;
  if (base < 1) base = 1;
  const int64_t n = (2 * sms + base - 1) / base;
  *splits = static_cast<int>(n < 1 ? 1 : n > 8 ? 8 : n);
  return 0;
}

int run(Args a, int64_t d, int dtype, cudaStream_t stream) {
  a.splits = 1;
  if (dtype == 0) {
    int err = dkv_splits(a.b, a.sk, a.kv, &a.splits);
    return err ? err : launch_bf16(a, d, stream);
  }
  if (dtype == 1) return launch_f32(a, d, stream);
  return -1;
}

}  // namespace

// float32 scratch that repro_flash_attention_bwd needs in `part`: the
// bfloat16 kernel's dK and dV partial sums (2 x splits x B Sk KV D), none
// for float32.  -1 if the device cannot be queried.
extern "C" int64_t repro_flash_attention_bwd_workspace(int64_t b, int64_t sk,
                                                       int64_t kv, int64_t d,
                                                       int dtype) {
  if (dtype != 0) return 0;
  int splits;
  if (dkv_splits(b, sk, kv, &splits)) return -1;
  return 2 * splits * b * sk * kv * d;
}

#ifndef REPRO_K4B_PLANTED_FAULTS
// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KV, D), contiguous;
// lse, delta float32 (B, H, Sq) scratch, part the workspace above.  dtype 0
// bfloat16, 1 float32.  Returns 0 or a CUDA error code (-1: unsupported
// head_dim or dtype).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    float* part, int64_t b, int64_t sq, int64_t sk, int64_t h, int64_t kv,
    int64_t d, int dtype, int causal, int window, void* stream) {
  Args a{q, k, v, o, dout, dq, dk, dv, lse, delta, part, b, sq, sk, h, kv,
         causal, window, 1, 1.0f / sqrtf(static_cast<float>(d))};
  return run(a, d, dtype, static_cast<cudaStream_t>(stream));
}
#else
// the same with a planted fault (see the top of the file)
extern "C" int repro_flash_attention_bwd_planted(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    float* part, int64_t b, int64_t sq, int64_t sk, int64_t h, int64_t kv,
    int64_t d, int dtype, int causal, int window, int fault,
    int64_t fault_tile, void* stream) {
  Args a{q, k, v, o, dout, dq, dk, dv, lse, delta, part, b, sq, sk, h, kv,
         causal, window, 1, 1.0f / sqrtf(static_cast<float>(d)), fault,
         fault_tile};
  return run(a, d, dtype, static_cast<cudaStream_t>(stream));
}
#endif
