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
// The backward (tpsf_physics_bwd_kernel, below the forward) replaces the
// custom_vjp backward of tactilesr_tpu/ops/pallas/tpsf_kernel.py:207-210
// (_bwd: jax.vjp of ops/psf.py::_physics_single at f32 HIGHEST).  Given the
// cotangents gl = dL/dLR (4x4) and, optionally, gh = dL/dHR, per sample:
//
//   G     = c (U^T gl U - mn sum(gl)) + gh      c = DEGRADE_SCALE / (1 - mn)
//   G0    = mask ? 0 : G                       (the second max is detached)
//   dalpha = sum(G0 * HR0) / alpha
//   dbeta  = alpha sum_o (h1[o] + h2[o]) g(o) 2 C_PSF o^2 / beta^3, where
//            h1[o] = sum_ij Q[i][j] D[i+o][j] with Q = G0 A, and
//            h2[o] = sum_ai G0[a][i] T[a][i+o]: the band of
//            dL/dA = alpha (G0 A D^T + G0^T A D) summed along its diagonals
//   dm     = sum(c (gl W + gl^T V) * U * C_MASK (x - c_t)^2 / m^2)
//            + sum(gl * DEGRADE_SCALE (T2 - S) / (1 - mn)^2) mn 100 / m^2
//            with V = U HR, W = U HR^T, T2 = V U^T, S = sum(HR)
//   gdepth = alpha A Q                          (only when asked for)
//
// Its plain version is tactilesr_torch/ops/psf.py::physics_vjp_plain.  It
// recomputes T, HR0, the mask and HR from D and never reads the forward's
// outputs, so forward and backward cannot disagree about the function.
//
// What bounds it: five banded passes per sample (T, HR0, the two
// correlations h2 and h1, and Q; six with gdepth), about 3.7 M f32 FMAs
// (7.5 MFLOP) against 40 KB read, so again the f32 peak and the shared-memory loads
// that feed it.  Design: one block of 640 threads per sample, one 4x4 tile
// or one (4 offsets x 4 columns) correlation tile per thread, in the same
// register-tile pattern as the forward (per step one 128-bit load of the
// moving operand, and either four broadcast g loads or one more 128-bit
// load, feed 16 FMAs).  Three 40 KB buffers hold D, T^T (then Q) and HR^T
// (then G0^T, then the correlation partials): 129 KB, one block per SM.
// dbeta's correlation partials are summed in a fixed order and each block
// writes its own three abm values, so the result is deterministic.  Plain
// f32 FMA and expf, no TF32, as the reference's HIGHEST precision.
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

// Block-wide max or sum over NWARPS warps; every thread gets the result.
// Starts with a barrier, so it also orders all earlier shared-memory
// accesses.
template <bool IS_MAX, int NWARPS = WARPS>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
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

// ---------------------------------------------------------------- backward
constexpr int BWD_THREADS = 640;                 // >= NTILES: one tile per thread
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int NOFF = TILES_1D * TILE;            // offsets -49..50 (g(50) = 0)

// dynamic shared memory layout (floats); every 128-bit access is aligned
constexpr int B_OFF_D = 0;                       // D
constexpr int B_OFF_T = B_OFF_D + NPIX;          // T^T, then Q
constexpr int B_OFF_H = B_OFF_T + NPIX;          // HR^T, then G0^T, then partials
constexpr int B_OFF_G = B_OFF_H + NPIX;          // gpad[199]
constexpr int B_OFF_U = B_OFF_G + 200;           // U[4][100]
constexpr int B_OFF_V = B_OFF_U + TAXELS * HR;   // V = U . HR
constexpr int B_OFF_W = B_OFF_V + TAXELS * HR;   // W = U . HR^T
constexpr int B_OFF_GU = B_OFF_W + TAXELS * HR;  // GU = gl . U
constexpr int B_OFF_GAM = B_OFF_GU + TAXELS * HR;         // gl[4][4]
constexpr int B_OFF_MASK = B_OFF_GAM + TAXELS * TAXELS;   // contact-mask bits
constexpr int B_OFF_RED = B_OFF_MASK + MASK_WORDS + 3;    // block-reduction scratch
constexpr int B_SMEM_FLOATS = B_OFF_RED + 32;
constexpr size_t B_SMEM_BYTES = B_SMEM_FLOATS * sizeof(float);  // 128,656 B

static_assert(BWD_THREADS >= NTILES, "one tile per thread");
static_assert(BWD_WARPS <= 32, "block_reduce scratch");
static_assert(B_OFF_U % 4 == 0 && B_OFF_GU % 4 == 0, "128-bit loads of U and GU");

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc[r][c] += sum_i X[i][j0+c] * Y[i+o0+r][j0+c] over the rows where both
// indices lie in [0, HR): four diagonal offsets o0..o0+3 of the row
// correlation of X and Y, on four columns.  Y's rows slide through a
// register window, so each step loads one row of X and one of Y.
__device__ __forceinline__ void diag_corr(const float* __restrict__ X, const float* __restrict__ Y,
                                          int o0, int j0, float acc[TILE][TILE]) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int i_lo = max(0, -o0 - (TILE - 1)), i_hi = min(HR - 1, HR - 1 - o0);
  float4 y[TILE];
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    const int k = i_lo + o0 + r;
    y[r] = (k >= 0 && k < HR) ? ld4(Y + k * HR + j0) : zero;
  }
  for (int i = i_lo; i <= i_hi; ++i) {
    const float4 x = ld4(X + i * HR + j0);
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      acc[r][0] = fmaf(x.x, y[r].x, acc[r][0]);
      acc[r][1] = fmaf(x.y, y[r].y, acc[r][1]);
      acc[r][2] = fmaf(x.z, y[r].z, acc[r][2]);
      acc[r][3] = fmaf(x.w, y[r].w, acc[r][3]);
    }
#pragma unroll
    for (int r = 0; r < TILE - 1; ++r) y[r] = y[r + 1];
    const int k = i + o0 + TILE;  // the window's last row at step i + 1
    y[TILE - 1] = k < HR ? ld4(Y + k * HR + j0) : zero;
  }
}

__global__ void __launch_bounds__(BWD_THREADS, 1)
tpsf_physics_bwd_kernel(const float* __restrict__ depth, const float* __restrict__ abm,
                        const float* __restrict__ g_lr, const float* __restrict__ g_hr,
                        float* __restrict__ g_abm, float* __restrict__ g_depth,
                        float c_psf, float c_mask, float disturbance, float degrade_scale) {
  extern __shared__ __align__(16) float smem[];
  float* bufD = smem + B_OFF_D;
  float* bufT = smem + B_OFF_T;
  float* bufH = smem + B_OFF_H;
  float* gpad = smem + B_OFF_G;
  float* U = smem + B_OFF_U;
  float* V = smem + B_OFF_V;
  float* W = smem + B_OFF_W;
  float* GU = smem + B_OFF_GU;
  float* gam = smem + B_OFF_GAM;
  unsigned* mask = reinterpret_cast<unsigned*>(smem + B_OFF_MASK);
  float* red = smem + B_OFF_RED;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float alpha = abm[3 * b + 0];
  const float beta = abm[3 * b + 1];
  const float m = abm[3 * b + 2];
  const float mn = expf(-100.0f / m);
  const float c = degrade_scale / (1.0f - mn);
  const bool active = tid < NTILES;
  const int i0 = (tid / TILES_1D) * TILE, j0 = (tid % TILES_1D) * TILE;  // tile / (offsets, columns)

  // 1. depth -> bufD and its max; gpad, U and the LR cotangent
  const float4* d4 = reinterpret_cast<const float4*>(depth + b * NPIX);
  float dmax = -INFINITY;
  for (int q = tid; q < NPIX / 4; q += BWD_THREADS) {
    const float4 v = d4[q];
    reinterpret_cast<float4*>(bufD)[q] = v;
    dmax = fmaxf(dmax, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
  }
  const float beta2 = beta * beta;
  for (int t = tid; t < GPAD_N; t += BWD_THREADS) {
    const int o = t - GPAD_C;
    const float of = (float)o;
    gpad[t] = (o >= -PSF_C && o <= PSF_C) ? expf(-c_psf * (of * of) / beta2) : 0.f;
  }
  for (int q = tid; q < TAXELS * HR; q += BWD_THREADS) {
    const int t = q / HR, x = q % HR;
    const float dx = (float)x - (float)(t * TAXEL_PITCH + TAXEL_C0);
    U[q] = expf(-c_mask * (dx * dx) / m);
  }
  if (tid < TAXELS * TAXELS) gam[tid] = g_lr ? g_lr[b * TAXELS * TAXELS + tid] : 0.f;
  dmax = block_reduce<true, BWD_WARPS>(dmax, red);  // publishes bufD, gpad, U, gam
  const float thr = dmax - disturbance;

  // 2. contact-mask bits; GU = gl . U
  for (int base = warp * 32; base < MASK_WORDS * 32; base += BWD_THREADS) {
    const int p = base + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, p < NPIX && bufD[p] > thr);
    if (lane == 0) mask[base / 32] = bits;
  }
  for (int q = tid; q < TAXELS * HR; q += BWD_THREADS) {
    const int a = q / HR, y = q % HR;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < TAXELS; ++k) s = fmaf(gam[a * TAXELS + k], U[k * HR + y], s);
    GU[q] = s;
  }

  // 3. T = A . D, stored transposed into bufT
  float acc[TILE][TILE];
  if (active) {
    band_tile(bufD, gpad, i0, j0, acc);
#pragma unroll
    for (int c2 = 0; c2 < TILE; ++c2)
      *reinterpret_cast<float4*>(bufT + (j0 + c2) * HR + i0) =
          make_float4(acc[0][c2], acc[1][c2], acc[2][c2], acc[3][c2]);
  }
  __syncthreads();

  // 4. acc = HR0^T / alpha: acc[r][c] is pixel (j0+c, i0+r) of HR0 / alpha.
  //    Second max over where(mask, 0, HR0).
  float second = -INFINITY;
  if (active) {
    band_tile(bufT, gpad, i0, j0, acc);
#pragma unroll
    for (int r = 0; r < TILE; ++r)
#pragma unroll
      for (int c2 = 0; c2 < TILE; ++c2) {
        const int p = (j0 + c2) * HR + i0 + r;
        const bool msk = (mask[p >> 5] >> (p & 31)) & 1u;
        second = fmaxf(second, msk ? 0.f : alpha * acc[r][c2]);
      }
  }
  second = block_reduce<true, BWD_WARPS>(second, red);

  // 5. HR^T into bufH, and S = sum(HR)
  float hsum = 0.f;
  if (active) {
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      float o[TILE];
#pragma unroll
      for (int c2 = 0; c2 < TILE; ++c2) {
        const int p = (j0 + c2) * HR + i0 + r;
        const bool msk = (mask[p >> 5] >> (p & 31)) & 1u;
        o[c2] = msk ? second : alpha * acc[r][c2];
        hsum += o[c2];
      }
      *reinterpret_cast<float4*>(bufH + (i0 + r) * HR + j0) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  hsum = block_reduce<false, BWD_WARPS>(hsum, red);  // publishes HR^T

  // 6. V[t][x] = sum_y U[t][y] HR^T[x][y] (threads 0..99, 128-bit along y);
  //    W[t][y] = sum_x U[t][x] HR^T[x][y] (threads 128..227)
  if (tid < HR) {
    float s[TAXELS] = {0.f, 0.f, 0.f, 0.f};
    for (int y = 0; y < HR; y += 4) {
      const float4 h = ld4(bufH + tid * HR + y);
#pragma unroll
      for (int t = 0; t < TAXELS; ++t) {
        const float4 u = ld4(U + t * HR + y);
        s[t] = fmaf(u.x, h.x, fmaf(u.y, h.y, fmaf(u.z, h.z, fmaf(u.w, h.w, s[t]))));
      }
    }
#pragma unroll
    for (int t = 0; t < TAXELS; ++t) V[t * HR + tid] = s[t];
  } else if (tid >= 128 && tid < 128 + HR) {
    const int y = tid - 128;
    float s[TAXELS] = {0.f, 0.f, 0.f, 0.f};
    for (int x = 0; x < HR; ++x) {
      const float h = bufH[x * HR + y];
#pragma unroll
      for (int t = 0; t < TAXELS; ++t) s[t] = fmaf(U[t * HR + x], h, s[t]);
    }
#pragma unroll
    for (int t = 0; t < TAXELS; ++t) W[t * HR + y] = s[t];
  }
  __syncthreads();  // V and W published; every read of HR^T is done

  // 7. dm's terms (threads 0..415); G0^T over bufH and dalpha (tiles)
  float dm_part = 0.f;
  const float m2 = m * m;
  if (tid < TAXELS * HR) {
    const int t = tid / HR, x = tid % HR;
    float gu = 0.f;
#pragma unroll
    for (int k = 0; k < TAXELS; ++k)
      gu = fmaf(gam[t * TAXELS + k], W[k * HR + x], fmaf(gam[k * TAXELS + t], V[k * HR + x], gu));
    const float dx = (float)x - (float)(t * TAXEL_PITCH + TAXEL_C0);
    dm_part = c * gu * U[tid] * (c_mask * (dx * dx) / m2);
  } else if (tid < TAXELS * HR + TAXELS * TAXELS) {
    const int q = tid - TAXELS * HR, a = q / TAXELS, k = q % TAXELS;
    float t2 = 0.f;
    for (int x = 0; x < HR; ++x) t2 = fmaf(V[a * HR + x], U[k * HR + x], t2);
    dm_part = gam[q] * (degrade_scale * (t2 - hsum) / ((1.0f - mn) * (1.0f - mn))) *
              (mn * 100.0f / m2);
  }
  float gsum = 0.f;
#pragma unroll
  for (int q = 0; q < TAXELS * TAXELS; ++q) gsum += gam[q];
  const float g_off = c * mn * gsum;
  float da_part = 0.f;
  if (active) {
    // G^T[i0+r][j0+c] = c sum_a U[a][j0+c] GU[a][i0+r] - c mn sum(gl) + gh[j0+c][i0+r]
    float gt[TILE][TILE];
#pragma unroll
    for (int r = 0; r < TILE; ++r)
#pragma unroll
      for (int c2 = 0; c2 < TILE; ++c2) gt[r][c2] = 0.f;
#pragma unroll
    for (int a = 0; a < TAXELS; ++a) {
      const float4 uj = ld4(U + a * HR + j0), gi = ld4(GU + a * HR + i0);
      const float ujv[TILE] = {uj.x, uj.y, uj.z, uj.w}, giv[TILE] = {gi.x, gi.y, gi.z, gi.w};
#pragma unroll
      for (int r = 0; r < TILE; ++r)
#pragma unroll
        for (int c2 = 0; c2 < TILE; ++c2) gt[r][c2] = fmaf(giv[r], ujv[c2], gt[r][c2]);
    }
    float ghv[TILE][TILE];
#pragma unroll
    for (int c2 = 0; c2 < TILE; ++c2) {
      const float4 h = g_hr ? ld4(g_hr + b * NPIX + (j0 + c2) * HR + i0) : make_float4(0.f, 0.f, 0.f, 0.f);
      ghv[0][c2] = h.x; ghv[1][c2] = h.y; ghv[2][c2] = h.z; ghv[3][c2] = h.w;
    }
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      float o[TILE];
#pragma unroll
      for (int c2 = 0; c2 < TILE; ++c2) {
        const int p = (j0 + c2) * HR + i0 + r;
        const bool msk = (mask[p >> 5] >> (p & 31)) & 1u;
        o[c2] = msk ? 0.f : c * gt[r][c2] - g_off + ghv[r][c2];
        da_part = fmaf(o[c2], acc[r][c2], da_part);
      }
      *reinterpret_cast<float4*>(bufH + (i0 + r) * HR + j0) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  const float d_alpha = block_reduce<false, BWD_WARPS>(da_part, red);
  const float d_m = block_reduce<false, BWD_WARPS>(dm_part, red);  // G0^T published

  // 8. h2 = corr(G0^T, T^T) for offsets o0..o0+3 on columns j0..j0+3
  const int o0 = i0 - PSF_C;
  float h[TILE] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
#pragma unroll
    for (int r = 0; r < TILE; ++r)
#pragma unroll
      for (int c2 = 0; c2 < TILE; ++c2) acc[r][c2] = 0.f;
    diag_corr(bufH, bufT, o0, j0, acc);
#pragma unroll
    for (int r = 0; r < TILE; ++r) h[r] = (acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]);
    // 9. Q^T = A . G0^T (A is symmetric); tile (i0+r, j0+c) is Q[j0+c][i0+r]
    band_tile(bufH, gpad, i0, j0, acc);
  }
  __syncthreads();  // every read of T^T is done
  if (active) {
#pragma unroll
    for (int c2 = 0; c2 < TILE; ++c2)
      *reinterpret_cast<float4*>(bufT + (j0 + c2) * HR + i0) =
          make_float4(acc[0][c2], acc[1][c2], acc[2][c2], acc[3][c2]);
  }
  __syncthreads();  // Q published; every read of G0^T is done

  // 10. h1 = corr(Q, D); partials of h1 + h2 into bufH as [column tile][offset]
  if (active) {
#pragma unroll
    for (int r = 0; r < TILE; ++r)
#pragma unroll
      for (int c2 = 0; c2 < TILE; ++c2) acc[r][c2] = 0.f;
    diag_corr(bufT, bufD, o0, j0, acc);
#pragma unroll
    for (int r = 0; r < TILE; ++r)
      bufH[(j0 / TILE) * NOFF + i0 + r] = h[r] + ((acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]));
    // 11. gdepth = alpha A . Q
    if (g_depth) {
      band_tile(bufT, gpad, i0, j0, acc);
#pragma unroll
      for (int r = 0; r < TILE; ++r)
        *reinterpret_cast<float4*>(g_depth + b * NPIX + (i0 + r) * HR + j0) =
            make_float4(alpha * acc[r][0], alpha * acc[r][1], alpha * acc[r][2], alpha * acc[r][3]);
    }
  }

  // 12. dbeta: offset o = t - 49 weighs h1 + h2 by dg/dbeta = g(o) 2 C_PSF o^2 / beta^3
  float db_part = 0.f;
  __syncthreads();  // partials published
  if (tid < NOFF) {
    float hs = 0.f;
    for (int k = 0; k < TILES_1D; ++k) hs += bufH[k * NOFF + tid];
    const float of = (float)(tid - PSF_C);
    db_part = hs * gpad[GPAD_C + tid - PSF_C] * (2.0f * c_psf * of * of / (beta2 * beta));
  }
  const float d_beta = alpha * block_reduce<false, BWD_WARPS>(db_part, red);
  if (g_abm && tid == 0) {
    g_abm[3 * b + 0] = d_alpha;
    g_abm[3 * b + 1] = d_beta;
    g_abm[3 * b + 2] = d_m;
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

// The backward over B samples on `stream`; returns the cudaError_t.  depth
// (B,100,100), abm (B,3), g_lr (B,4,4) or null, g_hr (B,100,100) or null;
// outputs g_abm (B,3) and g_depth (B,100,100), each written only when not
// null.  Contiguous f32 on the current device; depth, g_hr and g_depth
// 16-byte aligned.  B == 0 launches nothing.
extern "C" int tpsf_physics_bwd_launch(const float* depth, const float* abm, const float* g_lr,
                                       const float* g_hr, float* g_abm, float* g_depth,
                                       int batch, float c_psf, float c_mask, float disturbance,
                                       float degrade_scale, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      tpsf_physics_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  tpsf_physics_bwd_kernel<<<batch, BWD_THREADS, B_SMEM_BYTES, (cudaStream_t)stream>>>(
      depth, abm, g_lr, g_hr, g_abm, g_depth, c_psf, c_mask, disturbance, degrade_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* tpsf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
