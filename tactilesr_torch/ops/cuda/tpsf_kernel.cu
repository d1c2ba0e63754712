// Fused tPSF physics for Hopper (sm_90a), one thread block per sample.
//
// Replaces the Pallas TPU kernel tactilesr_tpu/ops/pallas/tpsf_kernel.py
// (tpsf_physics_pallas_raw -> _make_kernel -> _sample_body).  Per sample:
//
//   g[t]  = exp(-C_PSF (t-49)^2 / beta^2)                  t in [0, 99)
//   T     = A . D             A[i,k] = g[k-i+49] for |k-i| <= 49, else 0
//   HR0   = alpha * T . A^T
//   mask  = d > max(d) - DISTURBANCE
//   HR    = mask ? max(where(mask, 0, HR0)) : HR0
//   U[t,x]= exp(-C_MASK (x - 12 - 25t)^2 / m),  mn = exp(-100/m)
//   LR    = (U . HR . U^T - mn * sum(HR)) / (1 - mn) * DEGRADE_SCALE
//
// The plain PyTorch version is tactilesr_torch/ops/psf.py::physics_plain.
//
// What bounds it on an H100: the two banded 100x100 products, about
// 2 * 2 * 7,450 * 100 = 3.0 MFLOP of f32 FMA per sample, against 80 KB of
// HBM traffic (depth in, HR out): ~37 FLOP/byte, so with f32 FMA on the
// CUDA cores (no TF32: the reference's HIGHEST precision) the bound is the
// f32 non-tensor peak.  Feeding the FMAs from shared memory is the real
// limit: one load per FMA would cap the kernel at a quarter of that peak.
//
// Design: both banded products are one routine, out[i][j] = sum_k
// g(k-i) src[k][j], with each thread computing a 4x4 output tile in
// registers (per band step: one 128-bit load of src and four broadcast
// loads of g feed 16 FMAs), then storing the tile transposed.  Applied to
// D it yields T^T; applied to T^T it yields HR0^T / alpha, stored
// transposed as HR0.  g is zero-padded (gpad) so every tile runs the same
// FMA loop.  One 40 KB buffer holds D, then T^T, then HR (each stage
// finishes its reads before a barrier, then overwrites); the contact mask
// is kept as bits.  46 KB of shared memory per block.  Accumulation is
// plain f32 FMA; the exponentials use expf (never __expf / fast math),
// which the 1e-4 parity with the plain version needs.  Tensor cores
// (TF32/wgmma) and TMA are later work.
//
// Build: nvcc -O3 -gencode arch=compute_90a,code=sm_90a -std=c++17 -shared
//        -Xcompiler -fPIC  (done by tactilesr_torch/ops/cuda/__init__.py)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HR = 100;          // HR_SIZE
constexpr int NPIX = HR * HR;    // 10,000 pixels per sample
constexpr int PSF_N = 99;        // PSF_SIZE
constexpr int PSF_C = 49;        // PSF_CENTER
constexpr int GPAD_C = 99;       // gpad[GPAD_C + o] = g(o) for |o| <= 49, else 0
constexpr int GPAD_N = 2 * GPAD_C + 1;
constexpr int TAXELS = 4;
constexpr int TAXEL_C0 = 12;     // TAXEL_CENTER_0
constexpr int TAXEL_PITCH = 25;
constexpr int TILE = 4;                          // output tile is TILE x TILE
constexpr int TILES_1D = HR / TILE;              // 25
constexpr int NTILES = TILES_1D * TILES_1D;      // 625
constexpr int THREADS = 320;
constexpr int ROUNDS = (NTILES + THREADS - 1) / THREADS;  // 2
constexpr int WARPS = THREADS / 32;
constexpr int MASK_WORDS = (NPIX + 31) / 32;     // 313

// dynamic shared memory layout (floats); buf first keeps it 16-byte aligned
constexpr int OFF_BUF = 0;                       // D, then T^T, then HR
constexpr int OFF_G = OFF_BUF + NPIX;            // gpad[199]
constexpr int OFF_U = OFF_G + 200;               // U[4][100]
constexpr int OFF_V = OFF_U + TAXELS * HR;       // V = U . HR, [4][100]
constexpr int OFF_MASK = OFF_V + TAXELS * HR;    // contact-mask bits
constexpr int OFF_RED = OFF_MASK + MASK_WORDS + 3;  // block-reduction scratch
constexpr int SMEM_FLOATS = OFF_RED + 32;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);  // 46,112 B

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max or sum; every thread gets the result.  Starts with a
// barrier, so it also orders all earlier shared-memory accesses.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// acc[r][c] = sum_k g(k - (i0 + r)) * src[k][j0 + c] over the band of rows
// i0..i0+3; out-of-band taps read gpad's zeros.
__device__ __forceinline__ void band_tile(const float* __restrict__ src,
                                          const float* __restrict__ gpad, int i0, int j0,
                                          float acc[TILE][TILE]) {
#pragma unroll
  for (int r = 0; r < TILE; ++r)
#pragma unroll
    for (int c = 0; c < TILE; ++c) acc[r][c] = 0.f;
  const int k0 = max(0, i0 - PSF_C), k1 = min(HR - 1, i0 + TILE - 1 + PSF_C);
  for (int k = k0; k <= k1; ++k) {
    const float4 d = *reinterpret_cast<const float4*>(src + k * HR + j0);
    const float* gk = gpad + (GPAD_C + k - i0);
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      const float gr = gk[-r];
      acc[r][0] = fmaf(gr, d.x, acc[r][0]);
      acc[r][1] = fmaf(gr, d.y, acc[r][1]);
      acc[r][2] = fmaf(gr, d.z, acc[r][2]);
      acc[r][3] = fmaf(gr, d.w, acc[r][3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
tpsf_physics_kernel(const float* __restrict__ depth, const float* __restrict__ abm,
                    float* __restrict__ hr_out, float* __restrict__ lr_out,
                    float c_psf, float c_mask, float disturbance, float degrade_scale) {
  extern __shared__ __align__(16) float smem[];
  float* buf = smem + OFF_BUF;
  float* gpad = smem + OFF_G;
  float* U = smem + OFF_U;
  float* V = smem + OFF_V;
  unsigned* mask = reinterpret_cast<unsigned*>(smem + OFF_MASK);
  float* red = smem + OFF_RED;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float alpha = abm[3 * b + 0];
  const float beta = abm[3 * b + 1];
  const float m = abm[3 * b + 2];

  // 1. depth -> buf (128-bit loads), its max; gpad and U
  const float4* d4 = reinterpret_cast<const float4*>(depth + b * NPIX);
  float dmax = -INFINITY;
  for (int q = tid; q < NPIX / 4; q += THREADS) {
    const float4 v = d4[q];
    reinterpret_cast<float4*>(buf)[q] = v;
    dmax = fmaxf(dmax, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
  }
  const float beta2 = beta * beta;
  for (int t = tid; t < GPAD_N; t += THREADS) {
    const int o = t - GPAD_C;
    const float of = (float)o;
    gpad[t] = (o >= -PSF_C && o <= PSF_C) ? expf(-c_psf * (of * of) / beta2) : 0.f;
  }
  for (int q = tid; q < TAXELS * HR; q += THREADS) {
    const int t = q / HR, x = q % HR;
    const float dx = (float)x - (float)(t * TAXEL_PITCH + TAXEL_C0);
    U[q] = expf(-c_mask * (dx * dx) / m);
  }
  dmax = block_reduce<true>(dmax, red);  // its barriers also publish buf, gpad, U
  const float thr = dmax - disturbance;

  // 2. contact mask as bits: pixel p -> mask[p / 32] bit p % 32
  for (int base = warp * 32; base < MASK_WORDS * 32; base += THREADS) {
    const int p = base + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, p < NPIX && buf[p] > thr);
    if (lane == 0) mask[base / 32] = bits;
  }

  // 3. T = A . D, kept in registers, then stored transposed over D
  float acc[ROUNDS][TILE][TILE];
#pragma unroll
  for (int s = 0; s < ROUNDS; ++s) {
    const int t = tid + s * THREADS;
    if (t < NTILES) band_tile(buf, gpad, (t / TILES_1D) * TILE, (t % TILES_1D) * TILE, acc[s]);
  }
  __syncthreads();  // every read of D is done
#pragma unroll
  for (int s = 0; s < ROUNDS; ++s) {
    const int t = tid + s * THREADS;
    if (t < NTILES) {
      const int i0 = (t / TILES_1D) * TILE, j0 = (t % TILES_1D) * TILE;
#pragma unroll
      for (int c = 0; c < TILE; ++c)  // T^T[j0+c][i0..i0+3]
        *reinterpret_cast<float4*>(buf + (j0 + c) * HR + i0) =
            make_float4(acc[s][0][c], acc[s][1][c], acc[s][2][c], acc[s][3][c]);
    }
  }
  __syncthreads();

  // 4. the same routine on T^T gives HR0^T / alpha: tile (i0+r, j0+c) is
  //    pixel (j0+c, i0+r) of HR0.  Second max over where(mask, 0, HR0).
  float second = -INFINITY;
#pragma unroll
  for (int s = 0; s < ROUNDS; ++s) {
    const int t = tid + s * THREADS;
    if (t < NTILES) {
      const int i0 = (t / TILES_1D) * TILE, j0 = (t % TILES_1D) * TILE;
      band_tile(buf, gpad, i0, j0, acc[s]);
#pragma unroll
      for (int r = 0; r < TILE; ++r)
#pragma unroll
        for (int c = 0; c < TILE; ++c) {
          const float v = alpha * acc[s][r][c];
          acc[s][r][c] = v;
          const int p = (j0 + c) * HR + i0 + r;
          const bool msk = (mask[p >> 5] >> (p & 31)) & 1u;
          second = fmaxf(second, msk ? 0.f : v);
        }
    }
  }
  second = block_reduce<true>(second, red);  // its first barrier: every T^T read is done

  // 5. fixup; HR goes row-major into buf
  float hsum = 0.f;
#pragma unroll
  for (int s = 0; s < ROUNDS; ++s) {
    const int t = tid + s * THREADS;
    if (t < NTILES) {
      const int i0 = (t / TILES_1D) * TILE, j0 = (t % TILES_1D) * TILE;
#pragma unroll
      for (int c = 0; c < TILE; ++c) {
        const int p = (j0 + c) * HR + i0;
        float o[TILE];
#pragma unroll
        for (int r = 0; r < TILE; ++r) {
          const bool msk = (mask[(p + r) >> 5] >> ((p + r) & 31)) & 1u;
          o[r] = msk ? second : acc[s][r][c];
          hsum += o[r];
        }
        *reinterpret_cast<float4*>(buf + p) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
  hsum = block_reduce<false>(hsum, red);  // its barriers publish the final HR

  // 6. coalesced HR store; V = U . HR  (4 x 100)
  float4* h4 = reinterpret_cast<float4*>(hr_out + b * NPIX);
  for (int q = tid; q < NPIX / 4; q += THREADS) h4[q] = reinterpret_cast<const float4*>(buf)[q];
  for (int q = tid; q < TAXELS * HR; q += THREADS) {
    const int t = q / HR, x = q % HR;
    float a = 0.f;
    for (int y = 0; y < HR; ++y) a = fmaf(U[t * HR + y], buf[y * HR + x], a);
    V[q] = a;
  }
  __syncthreads();

  // 7. LR = (V . U^T - mn * sum(HR)) / (1 - mn) * scale
  if (tid < TAXELS * TAXELS) {
    const int a = tid / TAXELS, c = tid % TAXELS;
    float s = 0.f;
    for (int x = 0; x < HR; ++x) s = fmaf(V[a * HR + x], U[c * HR + x], s);
    const float mn = expf(-100.0f / m);
    lr_out[b * TAXELS * TAXELS + tid] = (s - mn * hsum) / (1.0f - mn) * degrade_scale;
  }
}

}  // namespace

// Launch over B samples on `stream`; returns the cudaError_t (0 = success).
// depth (B,100,100), abm (B,3), hr (B,100,100), lr (B,4,4): contiguous f32
// on the current device; depth and hr 16-byte aligned.  B == 0 launches
// nothing.
extern "C" int tpsf_physics_launch(const float* depth, const float* abm, float* hr,
                                   float* lr, int batch, float c_psf, float c_mask,
                                   float disturbance, float degrade_scale,
                                   void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      tpsf_physics_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  tpsf_physics_kernel<<<batch, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      depth, abm, hr, lr, c_psf, c_mask, disturbance, degrade_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* tpsf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
