// Kernel B1: fused AdaIN affine + Snake + prefix mask + dilated SAME conv.
//
// Replaces the TPU kernel styletts2_tpu/ops/vocoder_pallas.py
// fused_ada_snake_conv (Pallas body `_kernel`). For every output row t of
// every batch row b:
//
//   z[t, ci]   = x[t, ci] * scale[b, ci] + shift[b, ci]
//   z[t, ci]  += sin^2(alpha[ci] * z) / alpha[ci]        (Snake)
//   z[t, ci]   = 0 outside [0, n_valid[b])               (bucket padding)
//   z          = round to the I/O dtype
//   out[t, co] = sum_i sum_ci z[t + i*d - halo, ci] * w[i, ci, co] + bias[co]
//              (+ residual[t, co])
//
// and optionally the masked partial sums [sum, sum of squares] of the
// output, quantized to the I/O dtype, over each block's rows (the next
// AdaIN's instance-norm statistics without re-reading the tensor). The
// partials are written per block and summed by the caller, so results are
// deterministic (no atomics).
//
// What bounds it on an H100: the work is 2*T*C^2*k operations against
// about 2*T*C*itemsize bytes, i.e. 2*C*k/itemsize operations per byte
// (C=32, k=3, bf16: ~100; C=256, k=11: ~2800). Below ~300 ops/byte the
// tensor-core bf16 kernel would be memory bound; this kernel runs its
// products on the CUDA cores (f32 FMA), so it is bound by those
// operations at every shape of the main path.
//
// Design: a block owns TT output rows x CO_T output channels of one batch
// row (grid: time tiles x channel tiles x batch). It walks the input
// channels in chunks of KC: the chunk's TT + 2*halo rows are loaded once,
// transformed (affine, snake, mask, cast) on the way into shared memory,
// then each of the k taps streams its (KC, CO_T) weight slice through
// shared memory and every thread accumulates a 4 x 4 register tile in f32.
// The halo rows come from the neighbouring tiles' region of x and the
// prefix mask zeroes every row outside [0, n_valid), so edge tiles need no
// special case. The TPU kernel's sequential grid becomes this in-block
// loop; no wgmma or TMA yet.
//
// Numerics: f32 I/O uses exact sinf (true f32 everywhere, no TF32); bf16
// I/O uses the same minimax sin^2 polynomial as the TPU kernel, so the
// kernel and its plain PyTorch version (ops/vocoder_kernel.py) agree.
// Elementwise steps use the _rn intrinsics so that no FMA contraction
// changes the rounding of z before its cast to the I/O dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int KC = 32;   // input channels per shared-memory chunk
constexpr int ZS = KC + 1;  // padded row stride of the input tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// sin(y)^2 via mod-pi range reduction + degree-4 even minimax polynomial
// (vocoder_pallas.py _sin2_poly, same coefficients).
__device__ __forceinline__ float sin2_poly(float y) {
  const float r = __fsub_rn(
      y, __fmul_rn(3.14159265358979323846f,
                   rintf(__fmul_rn(y, 0.318309886183790671538f))));
  const float u = __fmul_rn(r, r);
  float p = 0.00011299663600091553f;
  p = __fadd_rn(__fmul_rn(p, u), -0.003101284637731907f);
  p = __fadd_rn(__fmul_rn(p, u), 0.04435612637758055f);
  p = __fadd_rn(__fmul_rn(p, u), -0.3332866101072116f);
  p = __fadd_rn(__fmul_rn(p, u), 0.9999919530071253f);
  return __fmul_rn(u, p);
}

template <typename T> struct Snake;
template <> struct Snake<float> {  // exact sin in the f32 path
  static __device__ __forceinline__ float sin2(float y) {
    const float s = sinf(y);
    return __fmul_rn(s, s);
  }
};
template <> struct Snake<__nv_bfloat16> {
  static __device__ __forceinline__ float sin2(float y) {
    return sin2_poly(y);
  }
};

template <typename T, int CO_T>
__global__ void __launch_bounds__(NT) ada_snake_conv_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ alpha,
    const T* __restrict__ w, const float* __restrict__ bias,
    const int* __restrict__ n_valid, const T* __restrict__ residual,
    T* __restrict__ out, float* __restrict__ stats, int t_len, int c,
    int k, int dil, int n_tiles) {
  constexpr int TX = CO_T / 4;  // threads along output channels
  constexpr int TY = NT / TX;   // threads along time
  constexpr int TT = TY * 4;    // output rows per block
  extern __shared__ float smem[];
  const int halo = dil * (k - 1) / 2;
  const int rows = TT + 2 * halo;
  float* z_s = smem;                // [rows][ZS]
  float* w_s = smem + rows * ZS;    // [KC][CO_T]

  const int tile = blockIdx.x;
  const int co0 = blockIdx.y * CO_T;
  const int b = blockIdx.z;
  const int t0 = tile * TT;
  const int nv = n_valid[b];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const size_t xrow0 = (size_t)b * t_len;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < c; ci0 += KC) {
    for (int idx = tid; idx < rows * KC; idx += NT) {
      const int r = idx / KC;
      const int cc = idx - r * KC;
      const int t = t0 - halo + r;
      float v = 0.f;
      if (t >= 0 && t < nv) {
        const int ci = ci0 + cc;
        const float a = alpha[ci];
        float z = __fadd_rn(__fmul_rn(to_f(x[(xrow0 + t) * c + ci]),
                                      scale[b * c + ci]),
                            shift[b * c + ci]);
        z = __fadd_rn(z, __fmul_rn(1.0f / a, Snake<T>::sin2(__fmul_rn(a, z))));
        v = to_f(from_f<T>(z));
      }
      z_s[r * ZS + cc] = v;
    }
    for (int tap = 0; tap < k; ++tap) {
      __syncthreads();  // z_s complete; previous tap done with w_s
      for (int idx = tid; idx < KC * CO_T; idx += NT) {
        const int kc = idx / CO_T;
        const int cc = idx - kc * CO_T;
        w_s[idx] = to_f(w[((size_t)tap * c + ci0 + kc) * c + co0 + cc]);
      }
      __syncthreads();
      const float* zt = z_s + (ty + tap * dil) * ZS;
#pragma unroll 4
      for (int kc = 0; kc < KC; ++kc) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = zt[i * TY * ZS + kc];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = w_s[kc * CO_T + tx + TX * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();  // all taps done before the next chunk overwrites z_s
  }

  float ssum[4] = {0.f, 0.f, 0.f, 0.f};
  float ssq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + TY * i;
    if (t >= t_len) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + TX * j;
      const size_t o = (xrow0 + t) * c + co;
      float v = __fadd_rn(acc[i][j], bias[co]);
      if (residual != nullptr) v = __fadd_rn(v, to_f(residual[o]));
      const T q = from_f<T>(v);
      out[o] = q;
      if (t < nv) {
        const float qf = to_f(q);
        ssum[j] += qf;
        ssq[j] = fmaf(qf, qf, ssq[j]);
      }
    }
  }
  if (stats == nullptr) return;
  // per-block partials: reduce the TY row-threads of each column in a fixed
  // order through shared memory (z_s is free after the last sync above)
  float* red_s = smem;             // [TY][CO_T]
  float* red_q = smem + TY * CO_T;  // [TY][CO_T]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_s[ty * CO_T + tx + TX * j] = ssum[j];
    red_q[ty * CO_T + tx + TX * j] = ssq[j];
  }
  __syncthreads();
  for (int cc = tid; cc < CO_T; cc += NT) {
    float s = 0.f, q = 0.f;
    for (int r = 0; r < TY; ++r) {
      s += red_s[r * CO_T + cc];
      q += red_q[r * CO_T + cc];
    }
    const size_t base = ((size_t)b * n_tiles + tile) * 2 * c + co0 + cc;
    stats[base] = s;
    stats[base + c] = q;
  }
}

template <int CO_T> constexpr int rows_per_block() { return (NT / (CO_T / 4)) * 4; }

int co_tile(int c) { return (c % 64 == 0) ? 64 : 32; }

template <typename T, int CO_T>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   const void* alpha, const void* w, const void* bias,
                   const void* n_valid, const void* residual, void* out,
                   void* stats, int batch, int t_len, int c, int k, int dil,
                   cudaStream_t stream) {
  constexpr int TT = rows_per_block<CO_T>();
  const int halo = dil * (k - 1) / 2;
  const int n_tiles = (t_len + TT - 1) / TT;
  size_t z_bytes = (size_t)(TT + 2 * halo) * ZS * sizeof(float);
  const size_t red_bytes = (size_t)2 * NT * 4 * sizeof(float);
  if (z_bytes < red_bytes) z_bytes = red_bytes;
  const size_t smem = z_bytes + (size_t)KC * CO_T * sizeof(float);
  auto kern = ada_snake_conv_kernel<T, CO_T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles, c / CO_T, batch);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(alpha),
      static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(n_valid), static_cast<const T*>(residual),
      static_cast<T*>(out), static_cast<float*>(stats), t_len, c, k, dil,
      n_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* scale, const void* shift,
                     const void* alpha, const void* w, const void* bias,
                     const void* n_valid, const void* residual, void* out,
                     void* stats, int batch, int t_len, int c, int k,
                     int dil, cudaStream_t stream) {
  if (co_tile(c) == 64)
    return launch<T, 64>(x, scale, shift, alpha, w, bias, n_valid, residual,
                         out, stats, batch, t_len, c, k, dil, stream);
  return launch<T, 32>(x, scale, shift, alpha, w, bias, n_valid, residual,
                       out, stats, batch, t_len, c, k, dil, stream);
}

}  // namespace

extern "C" {

// Output rows each block owns for channel count c: the stats buffer has
// ceil(T / rows) partials per batch row.
int ada_snake_conv_rows_per_block(int c) {
  return co_tile(c) == 64 ? rows_per_block<64>() : rows_per_block<32>();
}

// x, residual, out: (B, T, C) in the I/O dtype (bf16 when is_bf16, else
// f32); w: (k, C, C) (tap, in, out) in the I/O dtype; scale, shift: (B, C)
// f32; alpha, bias: (C,) f32; n_valid: (B,) int32; stats: (B, n_tiles, 2,
// C) f32 or null; residual may be null. All on the device, contiguous.
// Launches on `stream` and returns cudaGetLastError().
int ada_snake_conv(const void* x, const void* scale, const void* shift,
                   const void* alpha, const void* w, const void* bias,
                   const void* n_valid, const void* residual, void* out,
                   void* stats, int batch, int t_len, int c, int k, int dil,
                   int is_bf16, void* stream) {
  if (batch <= 0 || t_len <= 0 || c <= 0 || c % 32 != 0 || k <= 0 ||
      k % 2 == 0 || dil <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(x, scale, shift, alpha, w, bias,
                                        n_valid, residual, out, stats, batch,
                                        t_len, c, k, dil, s)
              : dispatch<float>(x, scale, shift, alpha, w, bias, n_valid,
                                residual, out, stats, batch, t_len, c, k, dil,
                                s);
  return (int)err;
}

}  // extern "C"
