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
// (bf16: C=32, k=3: ~100; C=256, k=11: ~2800). The card does ~295 bf16
// tensor-core operations per byte of HBM, so at the main path's shapes the
// C = 32/64 stages sit near the byte bound and the C = 128/256 stages are
// bound by the tensor cores.
//
// bf16 design (tensor cores). A block of NWG warpgroups owns TT = 64*NWG
// output rows x CO_T output channels (CO_T = C up to 128) of one batch row
// and walks the input channels in chunks of KC = 64 (32 at C = 32). A
// chunk's raw (TT + 2*halo) x KC rows of x arrive by cp.async into a
// shared z tile and are transformed in place (affine, Snake, mask, cast,
// with the _rn intrinsics and the sin^2 polynomial). The tile is stored
// K-major as rows of 8-channel 16-byte chunks in wgmma's 128-byte swizzle
// (no swizzle at C = 32), so tap i's A operand is the same tile shifted
// down by i*d rows: a descriptor whose start address is i*d rows further
// on, read from shared memory with no copy. The B operand is the tap's
// (KC, CO_T) weight slice in 8 K-row x 64-channel swizzled atoms, read
// N-major (imm-trans-b), so the prepacked (k, C_in, C_out) weight keeps its
// layout. The products are wgmma.mma_async m64nCO_Tk16 with f32
// accumulators (64 per thread at CO_T = 128). The epilogue stages acc +
// bias through shared memory, then adds the residual, casts and stores 16
// bytes per thread, and reduces the stats partials in a fixed order.
//   - `ada_snake_conv_tc_kernel` (C >= 128): one block per tile; each
//     (chunk, tap) step streams its weight slice by cp.async through a
//     ring of 4 slots, loads two steps ahead, and leaves its products in
//     flight while the next step is issued. Time goes to reading the
//     weights from L2 (each block reads all of them), the transform and
//     the products, in that order at k = 11.
//   - `ada_snake_conv_tc_resident_kernel` (C <= 64): all k weight slices
//     stay in shared memory; a persistent block walks row tiles, loading
//     the next tile's x while it transforms, multiplies (all taps' wgmmas
//     back to back) and stores the current one.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py phase 3, one run): the 96 bf16 launches of one phase-2
// call at frame bucket 256 take 5.997 ms in eager calls (CUDA events
// around the wrapper, the definition the earlier design was timed by;
// now mostly the host's time to issue each call) and 3.435 ms on the
// device (CUDA-graph replay), against a bound of 0.628 ms (bytes at 3.35
// TB/s); the earlier CUDA-core design of the bf16 path took 23.417 ms in
// eager calls, the plain PyTorch version 106.4 ms.
//
// f32 design (CUDA cores, `ada_snake_conv_f32_kernel`, kept true f32: no
// TF32): a block owns TT output rows x CO_T channels; each input-channel
// chunk of TT + 2*halo rows is transformed into shared memory once, then
// each tap streams its (KC, CO_T) weight slice through shared memory and
// every thread accumulates a 4 x 4 register tile with f32 FMAs.
//
// Numerics: f32 I/O uses exact sinf; bf16 I/O uses the same minimax sin^2
// polynomial as the TPU kernel, so the kernel and its plain PyTorch version
// (ops/vocoder_kernel.py) agree. Elementwise steps use the _rn intrinsics
// so that no FMA contraction changes the rounding of z before its cast to
// the I/O dtype. bf16 products are exact in f32; the tensor cores only sum
// them in another order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

typedef __nv_bfloat16 bf16;

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

// ---------------------------------------------------------------- f32 ----

constexpr int NT = 256;     // threads per block
constexpr int KC = 32;      // input channels per shared-memory chunk
constexpr int ZS = KC + 1;  // padded row stride of the input tile

template <int CO_T>
__global__ void __launch_bounds__(NT) ada_snake_conv_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ alpha,
    const float* __restrict__ w, const float* __restrict__ bias,
    const int* __restrict__ n_valid, const float* __restrict__ residual,
    float* __restrict__ out, float* __restrict__ stats, int t_len, int c,
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
        float z = __fadd_rn(__fmul_rn(x[(xrow0 + t) * c + ci],
                                      scale[b * c + ci]),
                            shift[b * c + ci]);
        const float sn = sinf(__fmul_rn(a, z));
        v = __fadd_rn(z, __fmul_rn(1.0f / a, __fmul_rn(sn, sn)));
      }
      z_s[r * ZS + cc] = v;
    }
    for (int tap = 0; tap < k; ++tap) {
      __syncthreads();  // z_s complete; previous tap done with w_s
      for (int idx = tid; idx < KC * CO_T; idx += NT) {
        const int kc = idx / CO_T;
        const int cc = idx - kc * CO_T;
        w_s[idx] = w[((size_t)tap * c + ci0 + kc) * c + co0 + cc];
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
      if (residual != nullptr) v = __fadd_rn(v, residual[o]);
      out[o] = v;
      if (t < nv) {
        ssum[j] += v;
        ssq[j] = fmaf(v, v, ssq[j]);
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
    const size_t base = ((size_t)b * 2 * c + co0 + cc) * n_tiles + tile;
    stats[base] = s;
    stats[base + (size_t)c * n_tiles] = q;
  }
}

template <int CO_T> constexpr int f32_rows() { return (NT / (CO_T / 4)) * 4; }

int f32_co_tile(int c) { return (c % 64 == 0) ? 64 : 32; }

template <int CO_T>
cudaError_t launch_f32(const float* x, const float* scale, const float* shift,
                       const float* alpha, const float* w, const float* bias,
                       const int* n_valid, const float* residual, float* out,
                       float* stats, int batch, int t_len, int c, int k,
                       int dil, cudaStream_t stream) {
  constexpr int TT = f32_rows<CO_T>();
  const int halo = dil * (k - 1) / 2;
  const int n_tiles = (t_len + TT - 1) / TT;
  size_t z_bytes = (size_t)(TT + 2 * halo) * ZS * sizeof(float);
  const size_t red_bytes = (size_t)2 * NT * 4 * sizeof(float);
  if (z_bytes < red_bytes) z_bytes = red_bytes;
  const size_t smem = z_bytes + (size_t)KC * CO_T * sizeof(float);
  auto kern = ada_snake_conv_f32_kernel<CO_T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles, c / CO_T, batch);
  kern<<<grid, NT, smem, stream>>>(x, scale, shift, alpha, w, bias, n_valid,
                                   residual, out, stats, t_len, c, k, dil,
                                   n_tiles);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bf16 ----

// Tile configuration by channel count (the largest of 256, 128, 64, 32
// dividing C): output channels per block CO_T, warpgroups of 64 rows per
// block NWG, and the blocks per SM the registers are sized for. Chosen
// on the H100 by timing candidate builds at the main path's shapes at
// frame bucket 256. At C = 256 and 128 the streaming kernel's time goes
// to reading each block's weights from L2, so tall tiles (128 and 256
// rows: 80 and 100 blocks) beat the 160 and 200 blocks of half the
// height: fewer than 132 blocks, but half the weight traffic.
template <int CO_T_, int NWG_, int MINB_> struct TcCfg {
  static constexpr int CO_T = CO_T_, NWG = NWG_, MINB = MINB_;
};
using Cfg256 = TcCfg<128, 2, 1>;
using Cfg128 = TcCfg<128, 4, 1>;
using Cfg64 = TcCfg<64, 2, 1>;
using Cfg32 = TcCfg<32, 4, 2>;
// weight ring slots of the streaming kernel (6 and 8 measured no faster)
constexpr int NS = 4;
int tc_class(int c) {
  return c % 256 == 0 ? 256 : c % 128 == 0 ? 128 : c % 64 == 0 ? 64 : 32;
}

// Shared-memory operand layouts of the bf16 kernel (offsets in bf16
// elements). The z tile holds rows of KCH channels and the weight slot
// KCH K-rows of CO_T channels, both in 16-byte chunks of 8 channels.
//
// KCH = 64 (C % 64 == 0): wgmma's 128-byte swizzle. A z row is 128 bytes
// and chunk g of row r sits at chunk g ^ (r % 8) of it, so rows are
// 128 bytes apart whatever row an operand starts at: tap i's A operand
// starts i*d rows (128*i*d bytes) further on; the hardware applies the
// swizzle to the address bits, so no descriptor field changes with the
// shift. The weight slot is made of 8 K-row x 64-channel atoms (1 KB),
// N-major, swizzled the same way.
//
// KCH = 32 (C = 32): no swizzle. z is stored as 8-channel groups, each a
// column of 16-byte rows: row r of group g at (g * rows_pad + r) * 8, so
// every 8 consecutive rows form a core matrix; rows_pad is odd so that the
// chunks of one row fall in distinct bank groups. The weight slot is made
// of 8 K-row x 8-channel core matrices.
template <int CO_T> struct Operands {
  static constexpr int KCH = CO_T < 64 ? CO_T : 64;  // channels per chunk
  static constexpr bool SW = KCH == 64;
  static constexpr int NB = CO_T / 8;  // 8-channel chunks along N

  static __device__ __forceinline__ int w_off(int kk, int h) {
    if (SW)
      return (h >> 3) * KCH * 64 + (kk >> 3) * 512 + (kk & 7) * 64 +
             (((h & 7) ^ (kk & 7)) << 3);
    return ((kk >> 3) * NB + h) * 64 + (kk & 7) * 8;
  }
  static __device__ __forceinline__ int z_off(int r, int g, int rows_pad) {
    if (SW) return r * 64 + ((g ^ (r & 7)) << 3);
    return (g * rows_pad + r) * 8;
  }
  // A of k16 step j: rows row0.. of the z tile, channels 16j..16j+15
  static __device__ __forceinline__ uint64_t desc_a(const bf16* zb, int row0,
                                                    int j, int rows_pad) {
    if (SW) return ptx::desc_sw128(zb + row0 * 64 + 16 * j, 16, 1024);
    return ptx::desc_noswizzle(zb + (2 * j * rows_pad + row0) * 8,
                               rows_pad * 16, 128);
  }
  // B of k16 step j: K-rows 16j..16j+15 of the weight slot
  static __device__ __forceinline__ uint64_t desc_b(const bf16* slot, int j) {
    if (SW) return ptx::desc_sw128(slot + 2 * j * 512, KCH * 128, 1024);
    return ptx::desc_noswizzle(slot + 2 * j * NB * 64, NB * 128, 128);
  }
};

struct TcLayout {
  int halo, rows, rows_pad, zbuf, n_chunks;
};

template <int CO_T>
__host__ __device__ TcLayout tc_layout(int c, int k, int dil, int nwg) {
  constexpr int KCH = Operands<CO_T>::KCH;
  TcLayout l;
  l.halo = dil * (k - 1) / 2;
  l.rows = 64 * nwg + 2 * l.halo;
  l.rows_pad = l.rows | 1;
  l.zbuf = (l.rows_pad * KCH + 511) / 512 * 512;  // 1 KB multiple
  l.n_chunks = c / KCH;
  return l;
}

// Bytes of the epilogue's f32 staging tile (64*nwg, CO_T + 8) and stats
// partials (2, warps, CO_T).
template <int CO_T> __host__ __device__ size_t epilogue_bytes(int nwg) {
  return ((size_t)64 * nwg * (CO_T + 8) + (size_t)2 * 4 * nwg * CO_T) * 4;
}

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return p + ((1024 - (ptx::smem_addr(p) & 1023)) & 1023);
}

// Raw x rows t0 - halo .. of input channels ci0..ci0+KCH into a z buffer
// by cp.async: only rows in [0, nv); the transform zeroes the rest.
template <class Op, int NTH>
__device__ __forceinline__ void load_x(bf16* zb, const TcLayout& L,
                                       const bf16* __restrict__ x,
                                       size_t xrow0, int c, int ci0, int t0,
                                       int nv, int tid) {
  constexpr int G = Op::KCH / 8;
  const bf16* xsrc = x + xrow0 * c + ci0;
  for (int idx = tid; idx < L.rows * G; idx += NTH) {
    const int r = idx / G;
    const int g = idx - r * G;
    const int t = t0 - L.halo + r;
    if (t >= 0 && t < nv)
      ptx::cp_async16(zb + Op::z_off(r, g, L.rows_pad),
                      xsrc + (size_t)t * c + 8 * g);
  }
}

// Weight slice w[tap, ci0..ci0+KCH, co0..co0+CO_T] into a slot by cp.async.
template <class Op, int NTH>
__device__ __forceinline__ void load_w(bf16* slot, const bf16* __restrict__ w,
                                       int c, int tap, int ci0, int co0,
                                       int tid) {
  const bf16* wsrc = w + ((size_t)tap * c + ci0) * c + co0;
  for (int idx = tid; idx < Op::KCH * Op::NB; idx += NTH) {
    const int kk = idx / Op::NB;
    const int h = idx - kk * Op::NB;
    ptx::cp_async16(slot + Op::w_off(kk, h), wsrc + (size_t)kk * c + 8 * h);
  }
}

// affine + Snake + mask + cast of the z buffer, in place; each thread keeps
// one 8-channel group (NTH is a multiple of KCH / 8)
template <class Op, int NTH>
__device__ __forceinline__ void transform(bf16* zb, const TcLayout& L,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ shift,
                                          const float* __restrict__ alpha,
                                          int b, int c, int ci0, int t0,
                                          int nv, int tid) {
  constexpr int G = Op::KCH / 8;
  const int g = tid % G;
  const int ci = ci0 + 8 * g;
  float sc[8], sh[8], al[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = scale[b * c + ci + j];
    sh[j] = shift[b * c + ci + j];
    al[j] = alpha[ci + j];
  }
  for (int r = tid / G; r < L.rows; r += NTH / G) {
    const int t = t0 - L.halo + r;
    uint4* p = reinterpret_cast<uint4*>(zb + Op::z_off(r, g, L.rows_pad));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < nv) {
      const uint4 raw = *p;
      const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 xf = __bfloat1622float2(in[j]);
        float zz[2] = {xf.x, xf.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = 2 * j + e;
          const float a = al[jj];
          const float z = __fadd_rn(__fmul_rn(zz[e], sc[jj]), sh[jj]);
          zz[e] = __fadd_rn(z, __fmul_rn(1.0f / a, sin2_poly(__fmul_rn(a, z))));
        }
        o[j] = __floats2bfloat162_rn(zz[0], zz[1]);
      }
    }
    *p = v;
  }
}

// Epilogue of one (TT = 64*NWG rows) x CO_T output tile. First pass: acc +
// bias in f32 into a row-major staging tile (row stride CO_T + 8 floats:
// the float2 stores of a half-warp hit 32 distinct banks). Second pass:
// each thread takes 8 channels (one 16-byte chunk) of a row at a time, adds
// the residual, casts, stores, and sums the stats of its channels over its
// rows; then the partials are summed over the lanes of a warp that share a
// chunk (a fixed butterfly) and over the warps in order. `stage` must be
// free for writing when every thread of the block has arrived.
template <int CO_T, int NWG>
__device__ __forceinline__ void epilogue(
    const float (&acc)[CO_T / 2], float* stage, const float* __restrict__ bias,
    const bf16* __restrict__ residual, bf16* __restrict__ out,
    float* __restrict__ stats, size_t xrow0, int c, int co0, int t0,
    int t_len, int nv, int b, int n_tiles, int tile) {
  constexpr int NTH = 128 * NWG;
  constexpr int TT = 64 * NWG;
  constexpr int SST = CO_T + 8;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __syncthreads();
  {
    const int r_lo = warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < CO_T / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float b0 = bias[co0 + col];
      const float b1 = bias[co0 + col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(stage + (r_lo + 8 * h) * SST + col) =
            make_float2(__fadd_rn(acc[4 * j + 2 * h], b0),
                        __fadd_rn(acc[4 * j + 2 * h + 1], b1));
    }
  }
  __syncthreads();
  constexpr int CG = CO_T / 8;  // 16-byte chunks per row
  constexpr int RL = NTH / CG;  // rows in flight
  const int cg = tid % CG;
  float ss[8], sq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ss[i] = sq[i] = 0.f;
  for (int r = tid / CG; r < TT; r += RL) {
    const int t = t0 + r;
    if (t >= t_len) break;
    const float* srow = stage + r * SST + 8 * cg;
    const float4 a0 = *reinterpret_cast<const float4*>(srow);
    const float4 a1 = *reinterpret_cast<const float4*>(srow + 4);
    float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const size_t o = (xrow0 + t) * c + co0 + 8 * cg;
    if (residual != nullptr) {
      const uint4 rr = *reinterpret_cast<const uint4*>(residual + o);
      const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&rr);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 rf = __bfloat1622float2(rp[i]);
        v[2 * i] = __fadd_rn(v[2 * i], rf.x);
        v[2 * i + 1] = __fadd_rn(v[2 * i + 1], rf.y);
      }
    }
    uint4 packed;
    __nv_bfloat162* qp = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qp[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(out + o) = packed;
    if (t < nv) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 qf = __bfloat1622float2(qp[i]);
        ss[2 * i] += qf.x;
        ss[2 * i + 1] += qf.y;
        sq[2 * i] = fmaf(qf.x, qf.x, sq[2 * i]);
        sq[2 * i + 1] = fmaf(qf.y, qf.y, sq[2 * i + 1]);
      }
    }
  }
  if (stats == nullptr) return;
#pragma unroll
  for (int m = CG; m < 32; m <<= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], m);
      sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], m);
    }
  float* red = stage + TT * SST;  // [2][NTH / 32][CO_T]
  if (lane < CG) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red[warp * CO_T + 8 * cg + i] = ss[i];
      red[(NTH / 32 + warp) * CO_T + 8 * cg + i] = sq[i];
    }
  }
  __syncthreads();
  for (int cc = tid; cc < CO_T; cc += NTH) {
    float s = 0.f, q = 0.f;
    for (int r = 0; r < NTH / 32; ++r) {
      s += red[r * CO_T + cc];
      q += red[(NTH / 32 + r) * CO_T + cc];
    }
    const size_t base = ((size_t)b * 2 * c + co0 + cc) * n_tiles + tile;
    stats[base] = s;
    stats[base + (size_t)c * n_tiles] = q;
  }
}

// Streaming kernel (C >= 128: the weights do not fit in shared memory).
// One block per (row tile, channel tile, batch row); step s is (chunk s/k,
// tap s%k), its weight slice streamed through a ring of NS slots.
template <int CO_T, int NWG, int MINB>
__global__ void __launch_bounds__(128 * NWG, MINB) ada_snake_conv_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ alpha,
    const bf16* __restrict__ w, const float* __restrict__ bias,
    const int* __restrict__ n_valid, const bf16* __restrict__ residual,
    bf16* __restrict__ out, float* __restrict__ stats, int t_len, int c,
    int k, int dil, int n_tiles) {
  constexpr int NTH = 128 * NWG;
  constexpr int TT = 64 * NWG;
  using Op = Operands<CO_T>;
  constexpr int KCH = Op::KCH;       // input channels per chunk
  constexpr int WSLOT = KCH * CO_T;  // bf16 per weight slot
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TcLayout L = tc_layout<CO_T>(c, k, dil, NWG);
  bf16* w_s = reinterpret_cast<bf16*>(align_1k(smem_raw));  // [NS][WSLOT]
  bf16* z_s = w_s + NS * WSLOT;                             // [2][zbuf]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;  // 16-row slice of the block's 64*NWG rows
  const int tile = blockIdx.x;
  const int co0 = blockIdx.y * CO_T;
  const int b = blockIdx.z;
  const int t0 = tile * TT;
  const int nv = min(n_valid[b], t_len);
  const size_t xrow0 = (size_t)b * t_len;
  const int n_steps = L.n_chunks * k;
  // Steps overlap: the products of step s stay in flight while step s + 1
  // is issued, and the loads of step s + ahead are issued at step s into
  // the slot of step s + ahead - NS <= s - 2, whose products are done. With
  // three or more chunks a z buffer is reloaded two chunks later, which
  // needs k >= ahead + 1; at k = 1 there every step is waited for.
  int ahead = NS - 2;
  bool overlap = true;
  if (L.n_chunks > 2) {
    ahead = min(ahead, k - 1);
    if (ahead < 1) {
      ahead = 1;
      overlap = false;
    }
  }

  // load unit u: the weight slice of step u, and at a chunk's first tap the
  // chunk's raw x rows
  auto issue = [&](int u) {
    if (u < n_steps) {
      const int ch = u / k;
      const int tap = u - ch * k;
      load_w<Op, NTH>(w_s + (u % NS) * WSLOT, w, c, tap, ch * KCH, co0, tid);
      if (tap == 0)
        load_x<Op, NTH>(z_s + (ch & 1) * L.zbuf, L, x, xrow0, c, ch * KCH, t0,
                        nv, tid);
    }
    ptx::cp_async_commit();  // one group per unit, empty past the end
  };

  float acc[CO_T / 2];
#pragma unroll
  for (int i = 0; i < CO_T / 2; ++i) acc[i] = 0.f;

  for (int u = 0; u < ahead; ++u) issue(u);
  for (int s = 0; s < n_steps; ++s) {
    ptx::cp_async_wait_dyn(ahead - 1);  // unit s is in
    ptx::fence_proxy_async();
    __syncthreads();  // unit s landed for all; step s - ahead done
    issue(s + ahead);
    const int ch = s / k;
    const int tap = s - ch * k;
    bf16* zb = z_s + (ch & 1) * L.zbuf;
    if (tap == 0) {
      transform<Op, NTH>(zb, L, scale, shift, alpha, b, c, ch * KCH, t0, nv,
                         tid);
      ptx::fence_proxy_async();
      __syncthreads();
    }
    // A: this warpgroup's 64 rows of z shifted down by tap * dil rows;
    // B: this tap's weight slice
    const int row0 = (warp >> 2) * 64 + tap * dil;
    const bf16* slot = w_s + (s % NS) * WSLOT;
    ptx::fence_regs(acc);
    ptx::wgmma_fence();
#pragma unroll
    for (int j = 0; j < KCH / 16; ++j)
      ptx::Wgmma<CO_T>::run(acc, Op::desc_a(zb, row0, j, L.rows_pad),
                            Op::desc_b(slot, j));
    ptx::wgmma_commit();
    if (overlap)
      ptx::wgmma_wait<1>();
    else
      ptx::wgmma_wait<0>();
    ptx::fence_regs(acc);
  }
  ptx::wgmma_wait<0>();
  ptx::fence_regs(acc);
  ptx::cp_async_wait<0>();
  // the staging tile reuses the weight slots and z, free once every warp
  // has arrived (the epilogue's first barrier)
  epilogue<CO_T, NWG>(acc, reinterpret_cast<float*>(w_s), bias, residual,
                      out, stats, xrow0, c, co0, t0, t_len, nv, b, n_tiles,
                      tile);
}

// Resident kernel (C <= 64: one input-channel chunk, and all k weight
// slices fit in shared memory). A persistent block loads the weights once
// and walks row tiles (b, tile) = item / n_tiles, item % n_tiles for item
// = blockIdx.x, + gridDim.x, ...; the next tile's x rows load by cp.async
// into the other z buffer while the current tile is transformed, multiplied
// (all k taps' wgmmas issued back to back, one wait) and stored.
template <int CO_T, int NWG, int MINB>
__global__ void __launch_bounds__(128 * NWG, MINB)
    ada_snake_conv_tc_resident_kernel(
        const bf16* __restrict__ x, const float* __restrict__ scale,
        const float* __restrict__ shift, const float* __restrict__ alpha,
        const bf16* __restrict__ w, const float* __restrict__ bias,
        const int* __restrict__ n_valid, const bf16* __restrict__ residual,
        bf16* __restrict__ out, float* __restrict__ stats, int t_len, int c,
        int k, int dil, int n_tiles, int n_items) {
  constexpr int NTH = 128 * NWG;
  constexpr int TT = 64 * NWG;
  using Op = Operands<CO_T>;
  constexpr int KCH = Op::KCH;
  constexpr int WSLOT = KCH * CO_T;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TcLayout L = tc_layout<CO_T>(c, k, dil, NWG);
  bf16* w_s = reinterpret_cast<bf16*>(align_1k(smem_raw));  // [k][WSLOT]
  bf16* z_s = w_s + k * WSLOT;                              // [2][zbuf]
  float* stage = reinterpret_cast<float*>(z_s + 2 * L.zbuf);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  auto load_item_x = [&](int item, int buf) {
    if (item < n_items) {
      const int b = item / n_tiles;
      const int tile = item - b * n_tiles;
      load_x<Op, NTH>(z_s + buf * L.zbuf, L, x, (size_t)b * t_len, c, 0,
                      tile * TT, min(n_valid[b], t_len), tid);
    }
    ptx::cp_async_commit();
  };
  for (int tap = 0; tap < k; ++tap)
    load_w<Op, NTH>(w_s + tap * WSLOT, w, c, tap, 0, 0, tid);
  load_item_x(blockIdx.x, 0);  // one group: all weights and the first x

  float acc[CO_T / 2];
  int buf = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, buf ^= 1) {
    // the other buffer was last read by the previous tile's products, done
    load_item_x(item + gridDim.x, buf ^ 1);
    ptx::cp_async_wait<1>();
    ptx::fence_proxy_async();
    __syncthreads();
    const int b = item / n_tiles;
    const int tile = item - b * n_tiles;
    const int t0 = tile * TT;
    const int nv = min(n_valid[b], t_len);
    bf16* zb = z_s + buf * L.zbuf;
    transform<Op, NTH>(zb, L, scale, shift, alpha, b, c, 0, t0, nv, tid);
    ptx::fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < CO_T / 2; ++i) acc[i] = 0.f;
    ptx::fence_regs(acc);
    ptx::wgmma_fence();
    for (int tap = 0; tap < k; ++tap) {
      const int row0 = (warp >> 2) * 64 + tap * dil;
#pragma unroll
      for (int j = 0; j < KCH / 16; ++j)
        ptx::Wgmma<CO_T>::run(acc, Op::desc_a(zb, row0, j, L.rows_pad),
                              Op::desc_b(w_s + tap * WSLOT, j));
    }
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();
    ptx::fence_regs(acc);
    epilogue<CO_T, NWG>(acc, stage, bias, residual, out, stats,
                        (size_t)b * t_len, c, 0, t0, t_len, nv, b, n_tiles,
                        tile);
  }
  ptx::cp_async_wait<0>();
}

template <class Cfg>
cudaError_t launch_tc(const bf16* x, const float* scale, const float* shift,
                      const float* alpha, const bf16* w, const float* bias,
                      const int* n_valid, const bf16* residual, bf16* out,
                      float* stats, int batch, int t_len, int c, int k,
                      int dil, cudaStream_t stream) {
  constexpr int CO_T = Cfg::CO_T, NWG = Cfg::NWG;
  constexpr int WSLOT_BYTES = Operands<CO_T>::KCH * CO_T * 2;
  const TcLayout L = tc_layout<CO_T>(c, k, dil, NWG);
  const int n_tiles = (t_len + 64 * NWG - 1) / (64 * NWG);
  const size_t epi = epilogue_bytes<CO_T>(NWG);
  // + 1 KB to align the start to the swizzle pattern's 1 KB
  const size_t resident =
      (size_t)k * WSLOT_BYTES + (size_t)2 * L.zbuf * 2 + epi + 1024;
  cudaError_t err;
  if (c == CO_T && L.n_chunks == 1 && resident <= 227 * 1024) {
    auto kern = ada_snake_conv_tc_resident_kernel<CO_T, NWG, Cfg::MINB>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)resident);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, 128 * NWG, resident)) != cudaSuccess)
      return err;
    const int n_items = n_tiles * batch;
    const int grid = min(n_items, sms * max(per_sm, 1));
    kern<<<grid, 128 * NWG, resident, stream>>>(
        x, scale, shift, alpha, w, bias, n_valid, residual, out, stats, t_len,
        c, k, dil, n_tiles, n_items);
    return cudaGetLastError();
  }
  size_t smem = (size_t)NS * WSLOT_BYTES + (size_t)2 * L.zbuf * 2;
  if (smem < epi) smem = epi;
  smem += 1024;
  auto kern = ada_snake_conv_tc_kernel<CO_T, NWG, Cfg::MINB>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles, c / CO_T, batch);
  kern<<<grid, 128 * NWG, smem, stream>>>(x, scale, shift, alpha, w, bias,
                                          n_valid, residual, out, stats,
                                          t_len, c, k, dil, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output rows each block owns for channel count c and I/O dtype: the stats
// buffer has ceil(T / rows) partials per batch row.
int ada_snake_conv_rows_per_block(int c, int is_bf16) {
  if (is_bf16) {
    const int cls = tc_class(c);
    return 64 * (cls == 256   ? Cfg256::NWG
                 : cls == 128 ? Cfg128::NWG
                 : cls == 64  ? Cfg64::NWG
                              : Cfg32::NWG);
  }
  return f32_co_tile(c) == 64 ? f32_rows<64>() : f32_rows<32>();
}

// x, residual, out: (B, T, C) in the I/O dtype (bf16 when is_bf16, else
// f32); w: (k, C, C) (tap, in, out) in the I/O dtype; scale, shift: (B, C)
// f32; alpha, bias: (C,) f32; n_valid: (B,) int32; stats: (B, 2, C,
// n_tiles) f32 or null; residual may be null. All on the device,
// contiguous, the bf16 tensors 16-byte aligned. Launches on `stream` and
// returns cudaGetLastError().
int ada_snake_conv(const void* x, const void* scale, const void* shift,
                   const void* alpha, const void* w, const void* bias,
                   const void* n_valid, const void* residual, void* out,
                   void* stats, int batch, int t_len, int c, int k, int dil,
                   int is_bf16, void* stream) {
  if (batch <= 0 || t_len <= 0 || c <= 0 || c % 32 != 0 || k <= 0 ||
      k % 2 == 0 || dil <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* al = static_cast<const float*>(alpha);
  const float* bi = static_cast<const float*>(bias);
  const int* nv = static_cast<const int*>(n_valid);
  float* sts = static_cast<float*>(stats);
  cudaError_t err;
  if (is_bf16) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    const bf16* rb = static_cast<const bf16*>(residual);
    bf16* ob = static_cast<bf16*>(out);
    const int cls = tc_class(c);
    auto launch = cls == 256   ? launch_tc<Cfg256>
                  : cls == 128 ? launch_tc<Cfg128>
                  : cls == 64  ? launch_tc<Cfg64>
                               : launch_tc<Cfg32>;
    err = launch(xb, sc, sh, al, wb, bi, nv, rb, ob, sts, batch, t_len, c, k,
                 dil, st);
  } else {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    const float* rf = static_cast<const float*>(residual);
    float* of = static_cast<float*>(out);
    err = f32_co_tile(c) == 64
              ? launch_f32<64>(xf, sc, sh, al, wf, bi, nv, rf, of, sts, batch,
                               t_len, c, k, dil, st)
              : launch_f32<32>(xf, sc, sh, al, wf, bi, nv, rf, of, sts, batch,
                               t_len, c, k, dil, st);
  }
  return (int)err;
}

}  // extern "C"
