// K5: mamba2's SSD decode mixer for sm_90a, between in_proj and out_proj.
//
// Replaces no TPU kernel: the JAX package decodes with plain jnp under jit
// (src/repro/models/ssm.py, ssm_apply_decode), which XLA fuses.  The
// port's plain version (ref.ssm_decode_mixer_ref, the same arithmetic)
// is about 40 PyTorch operations a layer, each a launch, and it passes
// the float32 state (B, H, N, P) through device memory about eight times
// a step.  This computes the same function in two launches that read and
// write the state once.
//
// What it computes, per batch row b (W = 2 di + 2 N + H columns of proj:
// z, then xBC, then dt; C = di + 2 N conv channels; T the model's type):
//   conv[c] = T(silu(T(T(sum_k win[k][c] w[k][c]) + bias[c])))  over the
//             window win = [conv_cache[b], xBC], which shifts by one;
//   dt[h]   = softplus(dt_raw[h] + dt_bias[h])  (logaddexp(x, 0)),
//   dec[h]  = exp(dt[h] * -exp(a_log[h])),
//   s[h,n,p] = s[h,n,p] dec[h] + B[n] (dt[h] x[h,p])   (float32 state),
//   y[h,p]  = T(sum_n C[n] s[h,n,p] + D[h] x[h,p]),
//   g       = T(y T(silu(z))),  out = T(T(g rsqrt(mean(g^2) + eps)) norm).
// Values are rounded to T exactly where the plain version holds a T
// tensor.  The state update rounds its product and its sum separately
// (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version's
// two elementwise passes do, so a step's state equals the plain CUDA
// version's bit for bit given the same dt; the sums over n and over di
// run in another order than the plain version's.
//
// Design.  Launch 1, one block per (head, row): the conv of the head's P
// x channels and of the row's 2 N B/C channels, then the head's 32 KB
// state slice (at N 128, P 64) read once and written once, 16 bytes a
// thread, its loads issued before the conv so they are in flight while
// it runs; y reduced over n through shared memory in a fixed order.
// Launch 2, one block per row: the gated RMS norm over di, in place on
// launch 1's y (the output tensor), and the B/C channels' window shift.  Race-freedom on the in-place caches: each x
// channel belongs to one head, whose block shifts its window after
// reading it; the B/C channels are read by every head of a row, so their
// window is shifted only in launch 2, which the stream orders after all
// of launch 1.  The B/C conv is computed again by each head block (2 N
// channels times K taps: a few thousand operations, its inputs in L2).
//
// What bounds it on the H100: bytes.  At B 16 and mamba2-780m's shapes
// (H 48, N 128, P 64, di 3,072) the state is 25.2 MB a layer, read and
// written once: 50.3 MB, plus about 0.6 MB of window, projections and
// outputs, 15.2 us at 3.35 TB/s.  The arithmetic is about 5 operations a
// state element, far below the card's rate.
//
// Built with -DREPRO_K5_PLANTED_FAULTS, the library is instead the
// planted-fault variant that the checks must catch: fault 1 leaves each
// head's last state row as it was (a loop bound off by one), fault 2
// leaves the B/C channels' window unshifted, fault 3 leaves out y's
// D x skip.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;     // launch 1: (head, row) blocks
constexpr int NORM_THREADS = 1024;  // launch 2: one block a row
constexpr int NORM_ITEMS = 8;       // d_inner up to 8,192
constexpr int MAX_WIDTH = 8;     // conv taps
constexpr int ROWS = 8;          // state rows a thread holds at once

#ifdef REPRO_K5_PLANTED_FAULTS
__device__ __forceinline__ bool planted(int fault, int which) {
  return fault == which;
}
#else
__device__ __forceinline__ bool planted(int, int) { return false; }
#endif

template <typename T> struct Elt;
template <> struct Elt<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};
template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

// the conv of channel c of row b over its window and the new input; with
// ``shift`` the window moves by one (the channel's owner only)
template <typename T>
__device__ __forceinline__ float conv_channel(
    const T* __restrict__ xbc, T* __restrict__ win, const T* __restrict__ w,
    const T* __restrict__ bias, int64_t c, int64_t ch, int width,
    bool shift) {
  using E = Elt<T>;
  float tap[MAX_WIDTH];
#pragma unroll
  for (int k = 0; k < MAX_WIDTH; ++k)
    if (k < width - 1) tap[k] = E::load(win + k * ch + c);
  const float in = E::load(xbc + c);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < MAX_WIDTH; ++k)
    if (k < width)
      acc += (k < width - 1 ? tap[k] : in) * E::load(w + k * ch + c);
  if (shift) {
#pragma unroll
    for (int k = 0; k < MAX_WIDTH; ++k)
      if (k < width - 1)
        E::store(win + k * ch + c, k + 1 < width - 1 ? tap[k + 1] : in);
  }
  return E::round(silu(E::round(E::round(acc) + E::load(bias + c))));
}

// three blocks an SM (80 registers; 77 without the hint): on an H100, 2 us
// faster a call on cold state than without it, and 3 us faster than four
// blocks an SM (64 registers and spills)
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
    state_kernel(const T* __restrict__ proj, T* __restrict__ conv_cache,
                 float* __restrict__ ssd, const T* __restrict__ conv_w,
                 const T* __restrict__ conv_b,
                 const float* __restrict__ dt_bias,
                 const float* __restrict__ a_log,
                 const float* __restrict__ d_skip, T* __restrict__ y_out,
                 int heads, int hd, int ns, int width, int fault) {
  using E = Elt<T>;
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int64_t di = static_cast<int64_t>(heads) * hd;
  const int64_t ch = di + 2 * ns;                   // conv channels
  const int64_t wp = di + ch + heads;               // proj width
  float* xs = smem;                                 // hd
  float* bc = xs + hd;                              // 2 ns: B then C
  float* red = bc + 2 * ns;                         // groups * hd

  // this thread's columns and rows of the state slice
  const int quads = hd / 4, groups = THREADS / quads;
  const int q = t % quads, g = t / quads;
  float4* s4 = reinterpret_cast<float4*>(
      ssd + ((static_cast<int64_t>(b) * heads + h) * ns) * hd) + q;
  const int row_step = groups * ROWS;
  float4 s[ROWS];
  if (g < ns) {                                     // loads in flight first
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int n = g + i * groups;
      if (n < ns) s[i] = __ldcs(s4 + static_cast<int64_t>(n) * quads);
    }
  }

  const T* xbc = proj + b * wp + di;
  T* win = conv_cache + static_cast<int64_t>(b) * (width - 1) * ch;
  for (int j = t; j < hd + 2 * ns; j += THREADS) {
    const bool mine = j < hd;                        // the head's x channels
    const int64_t c = mine ? h * hd + j : di + (j - hd);
    const float v = conv_channel(xbc, win, conv_w, conv_b, c, ch, width, mine);
    if (mine) xs[j] = v; else bc[j - hd] = v;
  }
  const float dtr = E::load(proj + b * wp + di + ch + h) + dt_bias[h];
  const float dt = fmaxf(dtr, 0.0f) + log1pf(expf(-fabsf(dtr)));
  const float dec = expf(dt * -expf(a_log[h]));
  __syncthreads();

  float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (g < ns) {
    float dx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dx[j] = __fmul_rn(dt, xs[4 * q + j]);
    for (int n0 = g; n0 < ns; n0 += row_step) {
      if (n0 != g) {                                // rows past the first ROWS
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int n = n0 + i * groups;
          if (n < ns) s[i] = __ldcs(s4 + static_cast<int64_t>(n) * quads);
        }
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int n = n0 + i * groups;
        if (n >= ns) continue;
        const float bn = bc[n], cn = bc[ns + n];
        float v[4] = {s[i].x, s[i].y, s[i].z, s[i].w};
        if (!(planted(fault, 1) && n == ns - 1)) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = __fadd_rn(__fmul_rn(v[j], dec), __fmul_rn(bn, dx[j]));
          __stcs(s4 + static_cast<int64_t>(n) * quads,
                 make_float4(v[0], v[1], v[2], v[3]));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = fmaf(cn, v[j], y[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[g * hd + 4 * q + j] = y[j];
  __syncthreads();
  for (int p = t; p < hd; p += THREADS) {
    float acc = 0.0f;
    for (int k = 0; k < groups; ++k) acc += red[k * hd + p];
    if (!planted(fault, 3))
      acc = __fadd_rn(acc, __fmul_rn(d_skip[h], xs[p]));
    E::store(y_out + b * di + h * hd + p, acc);
  }
}

// y (B, di) is normalised in place: each thread reads its elements once,
// keeps their gated values in registers over the block's reduction, and
// writes them back
template <typename T>
__global__ void __launch_bounds__(NORM_THREADS, 1)
    norm_kernel(const T* __restrict__ proj, T* __restrict__ conv_cache,
                T* __restrict__ y, const T* __restrict__ scale, int heads,
                int hd, int ns, int width, float eps, int fault) {
  using E = Elt<T>;
  __shared__ float warp_sums[NORM_THREADS / 32];
  const int b = blockIdx.x, t = threadIdx.x;
  const int di = heads * hd;
  const int64_t ch = di + 2 * ns, wp = di + ch + heads;
  const T* z = proj + b * wp;
  T* yr = y + static_cast<int64_t>(b) * di;

  float v[NORM_ITEMS];
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < NORM_ITEMS; ++i) {
    const int c = t + i * NORM_THREADS;
    v[i] = c < di ? E::round(E::load(yr + c) * E::round(silu(E::load(z + c))))
                  : 0.0f;
    sq = fmaf(v[i], v[i], sq);
  }

  // the B/C channels' window shift: every head block has read it
  if (!planted(fault, 2)) {
    const T* xbc = proj + b * wp + di;
    T* win = conv_cache + static_cast<int64_t>(b) * (width - 1) * ch;
    for (int64_t c = di + t; c < ch; c += NORM_THREADS) {
      for (int k = 0; k + 1 < width - 1; ++k)
        win[k * ch + c] = win[(k + 1) * ch + c];
      win[(width - 2) * ch + c] = xbc[c];
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (t % 32 == 0) warp_sums[t / 32] = sq;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < NORM_THREADS / 32; ++w) total += warp_sums[w];
  const float r = rsqrtf(total / static_cast<float>(di) + eps);
#pragma unroll
  for (int i = 0; i < NORM_ITEMS; ++i) {
    const int c = t + i * NORM_THREADS;
    if (c < di) E::store(yr + c, E::round(v[i] * r) * E::load(scale + c));
  }
}

template <typename T>
int launch(const void* proj, void* conv_cache, float* ssd, const void* conv_w,
           const void* conv_b, const float* dt_bias, const float* a_log,
           const float* d_skip, const void* norm, void* y, int batch,
           int heads, int hd, int ns, int width, float eps, int fault,
           cudaStream_t stream) {
  const int groups = THREADS / (hd / 4);
  const size_t smem = sizeof(float) * (hd + 2 * ns + groups * hd);
  state_kernel<T><<<dim3(heads, batch), THREADS, smem, stream>>>(
      static_cast<const T*>(proj), static_cast<T*>(conv_cache), ssd,
      static_cast<const T*>(conv_w), static_cast<const T*>(conv_b), dt_bias,
      a_log, d_skip, static_cast<T*>(y), heads, hd, ns, width, fault);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_kernel<T><<<batch, NORM_THREADS, 0, stream>>>(
      static_cast<const T*>(proj), static_cast<T*>(conv_cache),
      static_cast<T*>(y), static_cast<const T*>(norm), heads, hd, ns, width,
      eps, fault);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* proj, void* conv_cache, void* ssd, const void* conv_w,
             const void* conv_b, const void* dt_bias, const void* a_log,
             const void* d_skip, const void* norm, void* y, int batch,
             int heads, int hd, int ns, int width, int dtype, float eps,
             int fault, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(ssd);
  const float* bias = static_cast<const float*>(dt_bias);
  const float* al = static_cast<const float*>(a_log);
  const float* dk = static_cast<const float*>(d_skip);
  switch (dtype) {
    case 0:
      return launch<float>(proj, conv_cache, st, conv_w, conv_b, bias, al, dk,
                           norm, y, batch, heads, hd, ns, width, eps, fault,
                           s);
    case 1:
      return launch<__nv_bfloat16>(proj, conv_cache, st, conv_w, conv_b, bias,
                                   al, dk, norm, y, batch, heads, hd, ns,
                                   width, eps, fault, s);
    default:
      return -1;
  }
}

}  // namespace

// proj (B, W) T; conv_cache (B, K - 1, C) T and ssd (B, H, N, P) float32,
// both updated in place; conv_w (K, C), conv_b (C,), norm (di,) T;
// dt_bias, a_log, d_skip (H,) float32; y (B, di) T, the output (y before
// the norm is written there first).
// dtype 0 float32, 1 bfloat16.  Returns the CUDA error of the launches.
#ifndef REPRO_K5_PLANTED_FAULTS
extern "C" int repro_ssm_decode_mixer(
    const void* proj, void* conv_cache, void* ssd, const void* conv_w,
    const void* conv_b, const void* dt_bias, const void* a_log,
    const void* d_skip, const void* norm, void* y, int batch, int heads,
    int hd, int ns, int width, int dtype, float eps, void* stream) {
  return dispatch(proj, conv_cache, ssd, conv_w, conv_b, dt_bias, a_log,
                  d_skip, norm, y, batch, heads, hd, ns, width, dtype, eps, 0,
                  stream);
}
#else
// the same with a planted fault (see the top of the file)
extern "C" int repro_ssm_decode_mixer_planted(
    const void* proj, void* conv_cache, void* ssd, const void* conv_w,
    const void* conv_b, const void* dt_bias, const void* a_log,
    const void* d_skip, const void* norm, void* y, int batch, int heads,
    int hd, int ns, int width, int dtype, float eps, int fault,
    void* stream) {
  return dispatch(proj, conv_cache, ssd, conv_w, conv_b, dt_bias, a_log,
                  d_skip, norm, y, batch, heads, hd, ns, width, dtype, eps,
                  fault, stream);
}
#endif
