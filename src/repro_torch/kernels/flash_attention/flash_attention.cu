// K4: forward flash attention for the serving path's prefill, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention_pallas (body _flash_kernel), and computes what its plain
// reference flash_attention_ref computes: softmax(q k^T / sqrt(D)) v with
// float32 statistics, causal (key j <= query i) and sliding-window
// (j > i - window) masks on absolute positions from 0, and 0 for a row with
// no live key.
//
// Differences from the TPU kernel, by design:
//  * It reads q (B, Sq, H, D) and k/v (B, Sk, KV, D) through their strides
//    in the model's layout; query head h reads KV head h / (H / KV).  The
//    TPU wrapper repeats K/V across each GQA group and pads the sequences
//    to whole blocks; this kernel does neither.  Ragged ends are masked
//    inside the kernel, so padded keys never enter the softmax (the TPU
//    kernel lets zero-padded keys in when causal is false).
//  * Key tiles that the causal or window mask removes for the whole query
//    tile are never loaded: a local layer at window 512 reads about
//    (512 + 64) / 64 tiles per query tile instead of up to Sk / 64.
//
// bfloat16 (the model's dtype): one block of 4 warps takes 64 query rows of
// one (batch, head); each warp owns 16 rows.  Q, K and V tiles (64 rows x D)
// sit in dynamic shared memory, rows padded by 16 bytes so that fragment
// reads hit 32 distinct banks; at D = 256 that is 99 KiB, above the 48 KB
// static limit, so the launcher raises the block's limit first.  S = Q K^T
// and O += P V run on the tensor cores through warp-level
// mma.sync.m16n8k16 (bf16 in, f32 accumulate); the online softmax keeps the
// running max and sum per row in registers, and P goes from the S
// accumulator registers straight into the A fragment of P V.  The O
// accumulator is 16 x D float32 per warp (D / 2 registers a thread).
//
// float32: one warp per query row, D / 32 elements a lane, the dot product
// reduced across the warp and the softmax updated key by key with CUDA-core
// FMA.  It exists for completeness (tests, small float32 configurations);
// the serving path runs bfloat16.
//
// What bounds it on the H100: operations.  At gemma3-1b's prefill (B 4,
// S 2048, H 4, KV 1, D 256) a global layer does 4 D per live (query, key)
// pair, about 34.4 GFLOP, against about 42 MB of q, k, v and o.  This
// first version uses mma.sync without asynchronous copies or warp
// specialisation, and waits on each tile's load; wgmma and TMA are the
// later redesign.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // query rows per block (4 warps x 16)
constexpr int BK = 64;       // keys per shared-memory tile
constexpr int NWARPS = 4;
constexpr int PAD = 8;       // bf16 elements appended to each smem row
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int F32_ROWS = 8;  // query rows (warps) per float32 block

struct Strides {
  int64_t b, s, h;           // elements; the last dimension is contiguous
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + R) of one head into smem (row stride D + PAD); rows at
// or beyond `valid` are zero.  16-byte loads, coalesced along D.
template <int D, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, Strides st,
                                          int64_t b, int64_t head, int row0,
                                          int valid) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < R * CH; c += NWARPS * 32) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(
          src + b * st.b + static_cast<int64_t>(row0 + r) * st.s +
          head * st.h + col);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int sq, int sk, int h,
                   int group, Strides qs, Strides ks, Strides vs, int causal,
                   int window, float scale_log2) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sV = sK + BK * LD;

  // the longest query tiles (causal: the last ones) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int64_t bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int kvh = hi / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + warp * 16 + g;      // query of c0, c1; c2, c3: +8
  const int row_b = row_a + 8;

  load_tile<D, BQ>(sQ, q, qs, bi, hi, q0, sq - q0);

  // key tiles with at least one live key for some query of this tile
  const int k_hi = causal ? min(sk, q0 + BQ) : sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kb0 = k_lo / BK, kb1 = (k_hi + BK - 1) / BK;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {NEG, NEG};   // running max (log2 domain), rows a and b
  float l_r[2] = {0.f, 0.f};   // this thread's part of the running sum

  const __nv_bfloat16* qw = sQ + warp * 16 * LD;
  for (int kb = kb0; kb < kb1; ++kb) {
    const int key0 = kb * BK;
    __syncthreads();           // the previous tiles are consumed
    load_tile<D, BK>(sK, k, ks, bi, kvh, key0, sk - key0);
    load_tile<D, BK>(sV, v, vs, bi, kvh, key0, sk - key0);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = ld32(qw + g * LD + c);
      a[1] = ld32(qw + (g + 8) * LD + c);
      a[2] = ld32(qw + g * LD + c + 8);
      a[3] = ld32(qw + (g + 8) * LD + c + 8);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const __nv_bfloat16* kr = sK + (nt * 8 + g) * LD + c;
        mma_bf16(s[nt], a, ld32(kr), ld32(kr + 8));
      }
    }

    // mask, scale, and the tile's row maxima
    uint32_t live = 0;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b;
        const int col = key0 + nt * 8 + 2 * t + (e & 1);
        bool ok = col < sk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        live |= static_cast<uint32_t>(ok) << (nt * 4 + e);
        s[nt][e] = ok ? s[nt][e] * scale_log2 : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {   // a row's 64 scores span a quad of lanes
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (live >> (nt * 4 + e)) & 1u
                            ? exp2f(s[nt][e] - m_r[e >> 1]) : 0.f;
        s[nt][e] = p;
        l_r[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= corr[0]; acc[i][1] *= corr[0];
      acc[i][2] *= corr[1]; acc[i][3] *= corr[1];
    }

    // O += P V: P's accumulator layout is the A fragment of the next mma
    const unsigned short* sVu = reinterpret_cast<const unsigned short*>(sV);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const unsigned short* vr = sVu + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const unsigned short* p = vr + dt * 8;
        const uint32_t b0 = p[0] | (static_cast<uint32_t>(p[LD]) << 16);
        const uint32_t b1 = p[8 * LD] | (static_cast<uint32_t>(p[9 * LD]) << 16);
        mma_bf16(acc[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int row = r ? row_b : row_a;
    if (row < sq) {
      const float den = fmaxf(l_r[r], 1e-30f);
      __nv_bfloat16* orow =
          o + ((bi * sq + row) * static_cast<int64_t>(h) + hi) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
            pack_bf16(acc[dt][2 * r] / den, acc[dt][2 * r + 1] / den);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int sq,
                  int sk, int h, int group, Strides qs, Strides ks, Strides vs,
                  int causal, int window, float scale) {
  constexpr int R = D / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * F32_ROWS + threadIdx.x / 32;
  if (i >= sq) return;
  const int64_t bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int kvh = hi / group;
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
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int sk, int h, int group, Strides qs, Strides ks,
                Strides vs, int causal, int window, cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * (D + PAD) * 2;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  flash_fwd_bf16<D><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
      sk, h, group, qs, ks, vs, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int sq, int sk, int h, int group, Strides qs, Strides ks,
               Strides vs, int causal, int window, cudaStream_t stream) {
  const dim3 grid((sq + F32_ROWS - 1) / F32_ROWS, b * h);
  flash_fwd_f32<D><<<grid, F32_ROWS * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, h, group,
      qs, ks, vs, causal, window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o (B, Sq, H, D) contiguous; q, k, v by strides (elements).  dtype 0 is
// bfloat16, 1 is float32.  Returns the cudaError of the launch, or -1 for a
// head_dim, dtype or grid the kernel does not take.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int64_t b,
    int64_t sq, int64_t sk, int64_t h, int64_t kvh, int64_t d, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int dtype, int causal, int window,
    void* stream) {
  if (b * h > 65535 || sq > (1 << 30) || sk > (1 << 30) || kvh <= 0 ||
      h % kvh)
    return -1;
  if (b == 0 || sq == 0) return 0;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const int group = static_cast<int>(h / kvh);
  const int w = window > 0 ? window : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ib = static_cast<int>(b), isq = static_cast<int>(sq),
            isk = static_cast<int>(sk), ih = static_cast<int>(h);
#define REPRO_FA_CASE(DIM)                                                   \
  case DIM:                                                                  \
    return dtype == 0 ? launch_bf16<DIM>(q, k, v, o, ib, isq, isk, ih, group, \
                                         qs, ks, vs, causal, w, st)           \
                      : launch_f32<DIM>(q, k, v, o, ib, isq, isk, ih, group,  \
                                        qs, ks, vs, causal, w, st);
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
