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
// the kernel is bound by its f32 FMAs on the CUDA cores (no TF32: the TPU
// kernel runs them at Precision.HIGHEST).
//
// Design: the work is split over a grid of (row tiles x frequency tiles),
// so one 241-frame window runs 8 x 17 = 136 blocks on the 132 SMs.
// `log_mel_partial_kernel`: a block owns TN = 32 frames x TF = 64
// frequency columns. It streams (TN, KC) frame chunks and (KC, TF) cos/sin
// chunks through double-buffered shared memory by cp.async, each thread
// accumulating a 4 x 4 tile of re and of im; then power goes to shared
// memory and is multiplied into the block's (TN, M_pad) partial mel, which
// is written to a scratch tensor (n_freq_tiles, rows, M_pad).
// `log_mel_finish_kernel` sums the partials of each (row, mel) in tile
// order (deterministic, no atomics) and applies the log and the
// normalisation.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py phase 4, one run): at the style shape (1 x 72000, 241
// frames) 0.168 ms in eager calls (CUDA events around the wrapper, the
// definition the earlier design was timed by) and 0.148 ms on the device
// (CUDA-graph replay), against a bound of 0.0308 ms (f32 operations at
// 67 TFLOP/s); the earlier one-block-per-32-frames design took 4.013 ms
// in eager calls, the plain PyTorch version 3.399 ms.

#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int NT = 128;       // threads: 16 along columns x 8 along rows
constexpr int TN = 32;        // frames per block
constexpr int TF = 64;        // frequency columns per block
constexpr int KC = 32;        // samples per shared-memory chunk
constexpr int FS = KC + 4;    // frame row stride: 16-byte rows, no conflicts
constexpr int PS = TF + 4;    // power row stride
// dynamic shared memory, in floats: frames [2][TN][FS], cos and sin
// [2][KC][TF] each, power [TN][PS], filterbank rows [TF][m_pad]
constexpr int F_OFF_C = 2 * TN * FS;
constexpr int F_OFF_S = F_OFF_C + 2 * KC * TF;
constexpr int F_OFF_P = F_OFF_S + 2 * KC * TF;
constexpr int F_OFF_FB = F_OFF_P + TN * PS;

template <int MJ>  // mel columns padded to 16 * MJ
__global__ void __launch_bounds__(NT) log_mel_partial_kernel(
    const float* __restrict__ frames, const float* __restrict__ cos_b,
    const float* __restrict__ sin_b, const float* __restrict__ fb,
    float* __restrict__ partial, int n_rows, int n_fft, int f_pad) {
  constexpr int MP = 16 * MJ;
  extern __shared__ __align__(16) float smem[];
  float(*f_s)[TN][FS] = reinterpret_cast<float(*)[TN][FS]>(smem);
  float(*c_s)[KC][TF] = reinterpret_cast<float(*)[KC][TF]>(smem + F_OFF_C);
  float(*s_s)[KC][TF] = reinterpret_cast<float(*)[KC][TF]>(smem + F_OFF_S);
  float(*p_s)[PS] = reinterpret_cast<float(*)[PS]>(smem + F_OFF_P);
  float* fb_s = smem + F_OFF_FB;  // [TF][MP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4*tx .. 4*tx + 3
  const int ty = tid / 16;  // rows 4*ty .. 4*ty + 3
  const int row0 = blockIdx.x * TN;
  const int f0 = blockIdx.y * TF;
  const int n_valid_rows = min(TN, n_rows - row0);

  // rows past the end are never loaded: zero them once in both buffers
  for (int idx = tid; idx < 2 * TN * FS; idx += NT) {
    const int r = (idx / FS) % TN;
    if (r >= n_valid_rows) smem[idx] = 0.f;
  }
  // the filterbank rows of this frequency tile, needed after the loop
  for (int idx = tid; idx < TF * MP / 4; idx += NT)
    ptx::cp_async16(fb_s + 4 * idx, fb + (size_t)f0 * MP + 4 * idx);
  ptx::cp_async_commit();

  auto load = [&](int chunk, int buf) {
    const int s0 = chunk * KC;
    for (int idx = tid; idx < TN * KC / 4; idx += NT) {
      const int r = idx / (KC / 4);
      const int q = idx - r * (KC / 4);
      if (r < n_valid_rows)
        ptx::cp_async16(&f_s[buf][r][4 * q],
                        frames + (size_t)(row0 + r) * n_fft + s0 + 4 * q);
    }
    for (int idx = tid; idx < KC * TF / 4; idx += NT) {
      const int kk = idx / (TF / 4);
      const int q = idx - kk * (TF / 4);
      const size_t g = (size_t)(s0 + kk) * f_pad + f0 + 4 * q;
      ptx::cp_async16(&c_s[buf][kk][4 * q], cos_b + g);
      ptx::cp_async16(&s_s[buf][kk][4 * q], sin_b + g);
    }
    ptx::cp_async_commit();
  };

  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

  const int n_chunks = n_fft / KC;
  load(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < n_chunks) {
      load(ch + 1, buf ^ 1);
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 2
    for (int k4 = 0; k4 < KC; k4 += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&f_s[buf][4 * ty + i][k4]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 cb =
            *reinterpret_cast<const float4*>(&c_s[buf][k4 + q][4 * tx]);
        const float4 sb =
            *reinterpret_cast<const float4*>(&s_s[buf][k4 + q][4 * tx]);
        const float cv[4] = {cb.x, cb.y, cb.z, cb.w};
        const float sv[4] = {sb.x, sb.y, sb.z, sb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                         : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(av, cv[j], re[i][j]);
            im[i][j] = fmaf(av, sv[j], im[i][j]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is reloaded by the next iteration
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p_s[4 * ty + i][4 * tx + j] = __fadd_rn(__fmul_rn(re[i][j], re[i][j]),
                                              __fmul_rn(im[i][j], im[i][j]));
  __syncthreads();

  // partial mel of this frequency tile: rows 4*ty + i, mels tx + 16*j
  float mel[4][MJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) mel[i][j] = 0.f;
#pragma unroll 4
  for (int ff = 0; ff < TF; ++ff) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = p_s[4 * ty + i][ff];
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const float fv = fb_s[ff * MP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) mel[i][j] = fmaf(p[i], fv, mel[i][j]);
    }
  }
  float* dst = partial + ((size_t)blockIdx.y * n_rows + row0) * MP;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (4 * ty + i >= n_valid_rows) continue;
#pragma unroll
    for (int j = 0; j < MJ; ++j)
      dst[(size_t)(4 * ty + i) * MP + tx + 16 * j] = mel[i][j];
  }
}

__global__ void log_mel_finish_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out, int n_rows,
                                      int n_tiles, int m_pad, int n_mels,
                                      float mean, float stdv) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_rows * n_mels) return;
  const int row = idx / n_mels;
  const int m = idx - row * n_mels;
  float s = 0.f;
  for (int ft = 0; ft < n_tiles; ++ft)
    s = __fadd_rn(s, partial[((size_t)ft * n_rows + row) * m_pad + m]);
  out[idx] = __fdiv_rn(__fsub_rn(logf(__fadd_rn(1e-5f, s)), mean), stdv);
}

template <int MJ>
cudaError_t launch(const float* frames, const float* cos_b,
                   const float* sin_b, const float* fb, float* partial,
                   float* out, int n_rows, int n_fft, int f_pad, int n_mels,
                   float mean, float stdv, cudaStream_t stream) {
  const size_t smem = (size_t)(F_OFF_FB + TF * 16 * MJ) * sizeof(float);
  auto kern = log_mel_partial_kernel<MJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = f_pad / TF;
  dim3 grid((n_rows + TN - 1) / TN, n_tiles);
  kern<<<grid, NT, smem, stream>>>(frames, cos_b, sin_b, fb, partial, n_rows,
                                   n_fft, f_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = n_rows * n_mels;
  log_mel_finish_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      partial, out, n_rows, n_tiles, 16 * MJ, n_mels, mean, stdv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// frames: (n_rows, n_fft) f32; cos_b, sin_b: (n_fft, f_pad) f32 with
// f_pad % 64 == 0; fb: (f_pad, m_pad) f32 with m_pad = 16*ceil(n_mels/16),
// zero-padded; partial: (f_pad / 64, n_rows, m_pad) f32 scratch; out:
// (n_rows, n_mels) f32. n_fft % 32 == 0, n_mels <= 128. All on the device,
// contiguous, 16-byte aligned. Launches both passes on `stream` and
// returns cudaGetLastError().
int log_mel(const void* frames, const void* cos_b, const void* sin_b,
            const void* fb, void* partial, void* out, int n_rows, int n_fft,
            int f_pad, int n_mels, float mean, float stdv, void* stream) {
  if (n_rows <= 0 || n_fft <= 0 || n_fft % KC != 0 || f_pad % TF != 0 ||
      n_mels <= 0 || n_mels > 128)
    return (int)cudaErrorInvalidValue;
  const int mj = (n_mels + 15) / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fr = static_cast<const float*>(frames);
  const float* cb = static_cast<const float*>(cos_b);
  const float* sb = static_cast<const float*>(sin_b);
  const float* f = static_cast<const float*>(fb);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  switch (mj) {
#define CASE(J)                                                              \
  case J:                                                                    \
    err = launch<J>(fr, cb, sb, f, p, o, n_rows, n_fft, f_pad, n_mels, mean, \
                    stdv, s);                                                \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
