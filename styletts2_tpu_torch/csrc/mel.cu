// Kernel B2: fused log-mel front end after framing.
//
// Replaces the TPU kernel styletts2_tpu/ops/mel_pallas.py fused_log_mel
// (`_fused_forward`, Pallas body `_kernel`). For every frame row n:
//
//   re[n, f]  = sum_s frames[n, s] * cos_b[s, f]     (window folded in)
//   im[n, f]  = sum_s frames[n, s] * sin_b[s, f]
//   power     = re^2 + im^2                          (never leaves the SM)
//   mel[n, m] = sum_f power[n, f] * fb[f, m]
//   out[n, m] = (log(1e-5 + mel) - mean) / std
//
// What bounds it on an H100: 4*N*n_fft*F + 2*N*F*M operations (F =
// n_fft/2 + 1) against N*n_fft*4 + 2*n_fft*F*4 + N*M*4 bytes. At the style
// shape (N = 241 frames per 3-s window, n_fft 2048) that is ~500
// operations per byte of true f32 work, far above what the memory needs:
// the kernel is bound by its f32 FMAs.
//
// Design: a block owns TN frames and walks the frequency axis in tiles of
// TF columns. For each tile it streams (TN, KC) frame chunks and (KC, TF)
// basis chunks through shared memory and accumulates re and im in
// registers, writes power to shared memory, then multiplies it into the
// (TN, M) mel accumulator, which stays in registers across all frequency
// tiles. The log and normalisation are applied before the one store. No
// reduction crosses blocks, so the TPU kernel's sequential frequency grid
// axis becomes this in-block loop. All products are true f32 FMAs (no
// TF32), as the TPU kernel runs them at Precision.HIGHEST.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads: 16 along columns x 16 along rows
constexpr int TN = 32;   // frames per block
constexpr int TF = 64;   // frequency columns per tile
constexpr int KC = 32;   // samples per shared-memory chunk

template <int MJ>  // mel columns padded to 16 * MJ
__global__ void __launch_bounds__(NT) log_mel_kernel(
    const float* __restrict__ frames, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ fb,
    float* __restrict__ out, int n_rows, int n_fft, int f_pad, int n_mels,
    float mean, float stdv) {
  constexpr int MP = 16 * MJ;
  __shared__ float f_s[TN][KC + 1];
  __shared__ float c_s[KC][TF];
  __shared__ float s_s[KC][TF];
  __shared__ float p_s[TN][TF + 1];
  extern __shared__ float fb_s[];  // [TF][MP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.x * TN;

  float mel[2][MJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) mel[i][j] = 0.f;

  for (int f0 = 0; f0 < f_pad; f0 += TF) {
    float re[2][4], im[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int s0 = 0; s0 < n_fft; s0 += KC) {
      for (int idx = tid; idx < TN * KC; idx += NT) {
        const int r = idx / KC;
        const int cc = idx - r * KC;
        const int row = row0 + r;
        f_s[r][cc] = row < n_rows ? frames[(size_t)row * n_fft + s0 + cc]
                                  : 0.f;
      }
      for (int idx = tid; idx < KC * TF; idx += NT) {
        const int kk = idx / TF;
        const int cc = idx - kk * TF;
        const size_t g = (size_t)(s0 + kk) * f_pad + f0 + cc;
        c_s[kk][cc] = cos_b[g];
        s_s[kk][cc] = sin_b[g];
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float a[2], cb[4], sb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = f_s[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cb[j] = c_s[kk][tx + 16 * j];
          sb[j] = s_s[kk][tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(a[i], cb[j], re[i][j]);
            im[i][j] = fmaf(a[i], sb[j], im[i][j]);
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[ty + 16 * i][tx + 16 * j] =
            __fadd_rn(__fmul_rn(re[i][j], re[i][j]),
                      __fmul_rn(im[i][j], im[i][j]));
    for (int idx = tid; idx < TF * MP; idx += NT)
      fb_s[idx] = fb[(size_t)f0 * MP + idx];
    __syncthreads();
#pragma unroll 4
    for (int ff = 0; ff < TF; ++ff) {
      float p[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) p[i] = p_s[ty + 16 * i][ff];
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const float fv = fb_s[ff * MP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) mel[i][j] = fmaf(p[i], fv, mel[i][j]);
      }
    }
    __syncthreads();  // p_s and fb_s are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int m = tx + 16 * j;
      if (m < n_mels)
        out[(size_t)row * n_mels + m] =
            __fdiv_rn(__fsub_rn(logf(__fadd_rn(1e-5f, mel[i][j])), mean),
                      stdv);
    }
  }
}

template <int MJ>
cudaError_t launch(const float* frames, const float* cos_b,
                   const float* sin_b, const float* fb, float* out,
                   int n_rows, int n_fft, int f_pad, int n_mels, float mean,
                   float stdv, cudaStream_t stream) {
  const size_t smem = (size_t)TF * 16 * MJ * sizeof(float);
  auto kern = log_mel_kernel<MJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rows + TN - 1) / TN;
  kern<<<blocks, NT, smem, stream>>>(frames, cos_b, sin_b, fb, out, n_rows,
                                     n_fft, f_pad, n_mels, mean, stdv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// frames: (n_rows, n_fft) f32; cos_b, sin_b: (n_fft, f_pad) f32 with
// f_pad % 64 == 0; fb: (f_pad, m_pad) f32 with m_pad = 16*ceil(n_mels/16),
// zero-padded; out: (n_rows, n_mels) f32. n_fft % 32 == 0, n_mels <= 128.
// All on the device, contiguous. Launches on `stream` and returns
// cudaGetLastError().
int log_mel(const void* frames, const void* cos_b, const void* sin_b,
            const void* fb, void* out, int n_rows, int n_fft, int f_pad,
            int n_mels, float mean, float stdv, void* stream) {
  if (n_rows <= 0 || n_fft <= 0 || n_fft % KC != 0 || f_pad % TF != 0 ||
      n_mels <= 0 || n_mels > 128)
    return (int)cudaErrorInvalidValue;
  const int mj = (n_mels + 15) / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fr = static_cast<const float*>(frames);
  const float* cb = static_cast<const float*>(cos_b);
  const float* sb = static_cast<const float*>(sin_b);
  const float* f = static_cast<const float*>(fb);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  switch (mj) {
#define CASE(J)                                                            \
  case J:                                                                  \
    err = launch<J>(fr, cb, sb, f, o, n_rows, n_fft, f_pad, n_mels, mean,  \
                    stdv, s);                                              \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
