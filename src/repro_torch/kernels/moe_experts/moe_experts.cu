// K6: the routed SwiGLU experts of a dropless MoE layer for sm_90a, over
// token rows sorted by expert.
//
// Replaces no TPU kernel: the JAX package runs its experts as batched
// products over a capacity-bounded buffer (src/repro/models/moe.py),
// which reads every expert's weights whatever its load and, at a capacity
// that drops nothing, computes E times the rows.  Here expert e's rows
// are x[offsets[e] : offsets[e + 1]] (R rows of width D in all), and
//   h = T(silu(x gate[e]) * (x up[e])),   y = T(h down[e]),
// gate, up (E_pad, D, FF) and down (E_pad, FF, D) row-major, all
// bfloat16 (T), every product accumulated in float32 and rounded to T
// once, as the plain version (ref.moe_experts_ref) does.
//
// Design.  Two launches, k6_gate_up (both first-stage products, the
// SwiGLU in their epilogue, h stored in T) and k6_down (h down[e]); each
// block one (BM rows, BN columns) tile of one expert.  No host
// synchronisation: the grid holds an upper bound of the row tiles,
// ceil(R / BM) + min(E, R) (each expert with rows adds at most one
// partial tile), times the column tiles, a row tile's column tiles side
// by side so its rows stay in L2; each block's first warp finds its
// expert and rows from the device offsets by a prefix sum of the experts'
// tile counts, and surplus blocks exit at once, so an expert with no rows
// reads no weights.  The products are mma.sync m16n8k16 on tensor cores,
// operands staged through a cp.async ring of STAGES shared-memory tiles
// (rows padded by 16 bytes, so ldmatrix reads them without bank
// conflicts; the weights, N-major, through ldmatrix.trans); K and N tails
// are zero-filled, rows past the expert's are computed and not stored.
// Tile sizes follow the row count (ops.py picks the configuration):
// 16-row tiles for decode, where the active experts' weights bound it,
// 128-row tiles for prefill, where the products do.  k6_gate_up adds one to *active per expert with
// rows (its first tile's first column block), the counter the benchmark
// reads once after its traced window.  No atomics on data: a call's
// result is the same bits every time.
//
// Built with -DREPRO_K6_PLANTED_FAULTS, the library is instead the
// planted-fault variant that the checks must catch: fault 1 leaves the
// last depth tile out of the first stage's products, fault 2 reads each
// tile's weights from the next expert's, fault 3 takes the SiLU of the up
// product in place of the gate's.

#include <cstdint>
#include <tuple>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

#ifdef REPRO_K6_PLANTED_FAULTS
__device__ __forceinline__ bool planted(int fault, int which) {
  return fault == which;
}
#else
__device__ __forceinline__ bool planted(int, int) { return false; }
#endif

using T = __nv_bfloat16;

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros where ``ok`` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}


constexpr int MAX_EXPERTS = 256;     // 8 a lane in find_tile's scan

struct Tile {
  int expert;   // E when the block has no tile
  int row0;     // its first row
  int row_end;  // the end of its expert's rows
  int first;    // whether it is its expert's first row tile
};

// Row tile pid_m's expert and rows, found by warp 0 (a prefix sum over
// the experts' tile counts, 8 experts a lane at most) and shared with the
// block through ``out``.
template <int BM>
__device__ __forceinline__ Tile find_tile(const int64_t* offsets, int E,
                                          int pid_m, Tile* out) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (E + 31) / 32;
    const int lo = min(lane * per, E), hi = min(lo + per, E);
    int mine = 0;
    for (int e = lo; e < hi; ++e) {
      const int n = static_cast<int>(offsets[e + 1] - offsets[e]);
      mine += (n + BM - 1) / BM;
    }
    int incl = mine;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += v;
    }
    const int excl = incl - mine;
    const unsigned hit = __ballot_sync(0xffffffffu,
                                       excl <= pid_m && pid_m < incl);
    if (lane == 0 && hit == 0) *out = Tile{E, 0, 0, 0};
    if (hit != 0 && lane == __ffs(hit) - 1) {
      int start = excl;
      for (int e = lo; e < hi; ++e) {
        const int a = static_cast<int>(offsets[e]);
        const int b = static_cast<int>(offsets[e + 1]);
        const int n = (b - a + BM - 1) / BM;
        if (pid_m < start + n) {
          *out = Tile{e, a + (pid_m - start) * BM, b, pid_m == start};
          break;
        }
        start += n;
      }
    }
  }
  __syncthreads();
  return *out;
}

// One (BM, BN) tile of out = a b[e] (SWIGLU false: k6_down) or of
// silu(a b0[e]) * (a b1[e]) (SWIGLU true: k6_gate_up); a (R, K) sorted
// rows, b (E_pad, K, N), out (R, N), all row-major.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool SWIGLU>
__device__ __forceinline__ void tile_body(
    const T* __restrict__ a, const int64_t* __restrict__ offsets,
    const T* __restrict__ b0, const T* __restrict__ b1, T* __restrict__ out,
    int* __restrict__ active, int R, int K, int N, int E, int fault) {
  constexpr int NT = WM * WN * 32;
  constexpr int NMAT = SWIGLU ? 2 : 1;
  constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
  constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0, "tiles");
  constexpr int AS = BK + 8, BS = BN + 8;       // padded rows (elements)
  constexpr int A_TILE = BM * AS, B_TILE = BK * BS;
  constexpr int STAGE = A_TILE + NMAT * B_TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ Tile tile_s;

  const int tid = threadIdx.x;
  const int n_col = (N + BN - 1) / BN;
  const int pid_m = blockIdx.x / n_col, pid_n = blockIdx.x % n_col;
  const Tile tile = find_tile<BM>(offsets, E, pid_m, &tile_s);
  if (tile.expert >= E) return;                 // surplus tile
  if (SWIGLU && tile.first && pid_n == 0 && tid == 0) atomicAdd(active, 1);
  const int we = planted(fault, 2) ? (tile.expert + 1) % E : tile.expert;
  const T* bw[NMAT];
  bw[0] = b0 + static_cast<size_t>(we) * K * N;
  if constexpr (SWIGLU)
    bw[NMAT - 1] = b1 + static_cast<size_t>(we) * K * N;
  const int n0 = pid_n * BN;
  int k_tiles = (K + BK - 1) / BK;
  if (SWIGLU && planted(fault, 1)) k_tiles -= 1;

  auto load = [&](int stage, int kt) {
    T* sa = smem + stage * STAGE;
    const int k0 = kt * BK;
    constexpr int A_CHUNKS = BM * BK / 8, B_CHUNKS = BK * BN / 8;
#pragma unroll
    for (int it = 0; it < (A_CHUNKS + NT - 1) / NT; ++it) {
      const int c = tid + it * NT;
      if (A_CHUNKS % NT != 0 && c >= A_CHUNKS) break;
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int row = min(tile.row0 + r, R - 1);
      const bool ok = k0 + col < K;
      cp_async16(sa + r * AS + col,
                 ok ? a + static_cast<size_t>(row) * K + k0 + col : a, ok);
    }
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      T* sb = sa + A_TILE + m * B_TILE;
#pragma unroll
      for (int it = 0; it < (B_CHUNKS + NT - 1) / NT; ++it) {
        const int c = tid + it * NT;
        if (B_CHUNKS % NT != 0 && c >= B_CHUNKS) break;
        const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + col < N;
        cp_async16(sb + r * BS + col,
                   ok ? bw[m] + static_cast<size_t>(k0 + r) * N + n0 + col
                      : bw[m],
                   ok);
      }
    }
  };

  float acc[NMAT][MI][NI][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();             // stage kt landed; stage kt - 1 is free
    if (kt + STAGES - 1 < k_tiles)
      load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const T* sa = smem + (kt % STAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], sa + (wm * WTM + i * 16 + lane % 16) * AS + kk
                               + (lane / 16) * 8);
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        const T* sb = sa + A_TILE + m * B_TILE;
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, sb + (kk + lane % 8 + ((lane / 8) % 2) * 8)
                                         * BS
                                     + wn * WTN + j * 8 + (lane / 16) * 8);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma(acc[m][i][j], af[i], bf);
            mma(acc[m][i][j + 1], af[i], bf + 2);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int col = n0 + wn * WTN + j * 8 + t4 * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = tile.row0 + wm * WTM + i * 16 + g + half * 8;
        if (row >= tile.row_end || col >= N) continue;
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float x0 = acc[0][i][j][half * 2 + q];
          if (SWIGLU) {
            const float x1 = acc[NMAT - 1][i][j][half * 2 + q];
            const float gt = planted(fault, 3) ? x1 : x0;
            const float up = planted(fault, 3) ? x0 : x1;
            v[q] = gt / (1.0f + expf(-gt)) * up;
          } else {
            v[q] = x0;
          }
        }
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * N
                                     + col) = pack(v[0], v[1]);
      }
    }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32)
k6_gate_up(const T* x, const int64_t* offsets, const T* gate, const T* up,
           T* h, int* active, int R, int D, int FF, int E, int fault) {
  tile_body<BM, BN, BK, WM, WN, STAGES, true>(
      x, offsets, gate, up, h, active, R, D, FF, E, fault);
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32)
k6_down(const T* h, const int64_t* offsets, const T* down, T* y, int R,
        int D, int FF, int E, int fault) {
  tile_body<BM, BN, BK, WM, WN, STAGES, false>(
      h, offsets, down, down, y, nullptr, R, FF, D, E, fault);
}

template <int BM, int BN, int BK, int STAGES, int NMAT>
constexpr int smem_bytes() {
  return STAGES * (BM * (BK + 8) + NMAT * BK * (BN + 8)) * 2;
}

// One tile configuration: (BM, WM, WN) shared, then (BN, BK, STAGES) of
// each launch.
template <int BM, int WM, int WN, int BN1, int BK1, int S1, int BN2,
          int BK2, int S2>
int launch(const T* x, const int64_t* offsets, const T* gate, const T* up,
           const T* down, T* h, T* y, int* active, int R, int D, int FF,
           int E, int fault, cudaStream_t stream) {
  constexpr int threads = WM * WN * 32;
  const int row_tiles = (R + BM - 1) / BM + min(E, R);
  auto k1 = k6_gate_up<BM, BN1, BK1, WM, WN, S1>;
  constexpr int smem1 = smem_bytes<BM, BN1, BK1, S1, 2>();
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<row_tiles * ((FF + BN1 - 1) / BN1), threads, smem1, stream>>>(
      x, offsets, gate, up, h, active, R, D, FF, E, fault);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto k2 = k6_down<BM, BN2, BK2, WM, WN, S2>;
  constexpr int smem2 = smem_bytes<BM, BN2, BK2, S2, 1>();
  err = cudaFuncSetAttribute(
      k2, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<row_tiles * ((D + BN2 - 1) / BN2), threads, smem2, stream>>>(
      h, offsets, down, y, R, D, FF, E, fault);
  return static_cast<int>(cudaGetLastError());
}

// The tile configurations, each the fastest of a sweep on an H100 at the
// qwen2-moe cell's shapes: cfg 0 16-row tiles (decode, 16 rows), 1 64-row,
// 2 128-row (prefill, 32,768 rows).
int dispatch(const void* x, const void* offsets, const void* gate,
             const void* up, const void* down, void* h, void* y, void* active,
             int R, int D, int FF, int E, int cfg, int fault,
             cudaStream_t stream) {
  if (R <= 0) return 0;
  if (E < 1 || E > MAX_EXPERTS || D % 8 || FF % 8) return -2;
  const auto args = std::make_tuple(
      static_cast<const T*>(x), static_cast<const int64_t*>(offsets),
      static_cast<const T*>(gate), static_cast<const T*>(up),
      static_cast<const T*>(down), static_cast<T*>(h), static_cast<T*>(y),
      static_cast<int*>(active), R, D, FF, E, fault, stream);
  switch (cfg) {
    case 0:
      return std::apply(launch<16, 1, 4, 64, 128, 3, 256, 32, 6>, args);
    case 1:
      return std::apply(launch<64, 2, 2, 64, 32, 4, 128, 32, 4>, args);
    case 2:
      return std::apply(launch<128, 2, 2, 64, 64, 3, 128, 32, 4>, args);
    default:
      return -1;
  }
}

}  // namespace

// x (R, D) rows sorted by expert, offsets (E + 1,) int64, gate/up (E_pad,
// D, FF), down (E_pad, FF, D), h (R, FF) scratch, y (R, D) out, all
// bfloat16; active an int32 device counter; cfg the tile configuration.
// Returns 0 or an error code.
#ifndef REPRO_K6_PLANTED_FAULTS
extern "C" int repro_moe_experts(const void* x, const void* offsets,
                                 const void* gate, const void* up,
                                 const void* down, void* h, void* y,
                                 void* active, int R, int D, int FF, int E,
                                 int cfg, cudaStream_t stream) {
  return dispatch(x, offsets, gate, up, down, h, y, active, R, D, FF, E, cfg,
                  0, stream);
}
#else
extern "C" int repro_moe_experts_planted(
    const void* x, const void* offsets, const void* gate, const void* up,
    const void* down, void* h, void* y, void* active, int R, int D, int FF,
    int E, int cfg, int fault, cudaStream_t stream) {
  return dispatch(x, offsets, gate, up, down, h, y, active, R, D, FF, E, cfg,
                  fault, stream);
}
#endif
