// Fused tPSF physics for Hopper (sm_90a): a forward and a backward kernel,
// one thread block per sample.
//
// tpsf_physics_kernel replaces the Pallas TPU kernel
// tactilesr_tpu/ops/pallas/tpsf_kernel.py (tpsf_physics_pallas_raw ->
// _make_kernel -> _sample_body).  Per sample:
//
//   g[t]  = exp(-C_PSF (t-49)^2 / beta^2)                  t in [0, 99)
//   T     = A . D             A[i,k] = g[k-i+49] for |k-i| <= 49, else 0
//   HR0   = alpha * T . A^T
//   mask  = d > max(d) - DISTURBANCE
//   HR    = mask ? max(where(mask, 0, HR0)) : HR0
//   U[t,x]= exp(-C_MASK (x - 12 - 25t)^2 / m),  mn = exp(-100/m)
//   LR    = (U . HR . U^T - mn * sum(HR)) / (1 - mn) * DEGRADE_SCALE
//
// Its plain PyTorch version is tactilesr_torch/ops/psf.py::physics_plain.
//
// tpsf_physics_bwd_kernel replaces the custom_vjp backward of
// tactilesr_tpu/ops/pallas/tpsf_kernel.py:207-210 (_bwd: jax.vjp of
// ops/psf.py::_physics_single at f32 HIGHEST).  Given the cotangents
// gl = dL/dLR (4x4) and, optionally, gh = dL/dHR, per sample:
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
// What bounds them on an H100: f32 FMA on the CUDA cores (no TF32: the
// reference's HIGHEST precision).  The forward does two banded 100x100
// passes, 2 * 7,450 * 100 FMAs each, about 3.06 MFLOP per sample against
// 80 KB of HBM traffic (37 FLOP/byte); the backward as training calls it
// five banded passes (T, HR0, the correlations h2 and h1, and Q; six with
// gdepth), about 7.6 MFLOP against 40 KB.  Both sit far above the card's
// 20 FLOP/byte f32 ridge, so the 67 TFLOP/s f32 peak is the bound.
//
// Load model of the inner loops.  An SM issues 4 warp-FFMAs per clock and
// its shared memory serves one 128-byte wavefront per clock.  Every banded
// pass is one of two routines over a register tile of RT = 10 rows x 4
// columns (40 accumulators a thread):
//   band_tile: out[i][j] = sum_k g(k-i) src[k][j].  Per band step one
//     128-bit load of a src row segment (4 wavefronts a warp) and one
//     32-bit load of the newest g tap (1 wavefront: the warp reads at most
//     two addresses) feed 40 FFMAs (10 FMA-clocks a warp): 5 wavefronts
//     per 10 FMA-clocks, so the loop is bound by the FMAs.  The other nine
//     taps slide through a 10-register window; the k loop is unrolled by
//     the window length so that the window index is a constant and the
//     shift is renaming, not moves.
//   diag_corr: 10 diagonal offsets x 4 columns of a row correlation.  Per
//     step one 128-bit X row and one 128-bit Y row (8 wavefronts) feed 40
//     FFMAs (10 FMA-clocks); Y's rows slide through a window of ten float4.
// One pass is 250 tiles (10 row blocks x 25 column tiles).  A row block's
// band has 59, 69, 79, 89, 99, 99, 89, 79, 69 or 59 steps; each is padded
// by one all-zero-tap step (the tap g(+-50) is 0 and the extra row lies in
// the map) to 60 ... 100, a multiple of the window, so 800 steps x 40 FMAs
// x 25 tiles = 800K FMAs a pass against 745K useful (7% waste).  Tiles are
// numbered so that row blocks q and 9-q, whose bands are equally long, are
// in one pair: tile t is in pair p = t / 50 (60 + 10p steps), and a warp of
// 32 tiles spans at most two pairs.  A pass then issues 660 warp-steps
// against the 625 of perfectly equal warps: divergence costs 5%.
//
// Forward: 256 threads (one tile each, 6 idle), 47 KB of shared memory,
// __launch_bounds__(256, 3): three blocks (24 warps) per SM, 78 registers.
// Depth reaches shared memory by one TMA bulk copy (40,000 B, completion
// on an mbarrier) that overlaps the expf work of gpad and U; the max and the
// mask bits read it after the mbarrier completes.  One 40 KB buffer holds D,
// then T^T (in prow order, below), then HR; HR0 stays in registers across
// the second-max reduction, and HR leaves by one bulk store that overlaps V
// and LR.
//
// Backward: 256 threads, two 40 KB buffers X and Y, 10 KB of correlation
// partials and the small arrays: 96 KB and 128 registers, so two blocks per
// SM and B <= 264 runs in one wave.  X holds D, then HR^T, then G0^T, then
// D again (a second bulk copy, from L2, once Q is formed); Y holds T^T, then
// Q.  The tile coordinates are re-derived after each long loop (my_tile), so
// that the kernel fits 128 registers without spilling.
// dbeta's partials are summed in a fixed order and each block writes its
// own three abm values: no atomics, and results are bitwise reproducible.
//
// Both: plain f32 FMA with expf (never __expf or fast math), which the
// 1e-4 HR and 1e-3 gradient parity with the plain versions needs; an
// all-zero map gives exactly zero HR, LR and abm gradient.
//
// Build: nvcc -O3 -gencode arch=compute_90a,code=sm_90a -std=c++17 -shared
//        -Xcompiler -fPIC -Xptxas -v  (done by tactilesr_torch/ops/cuda/__init__.py)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HR = 100;          // HR_SIZE
constexpr int NPIX = HR * HR;    // 10,000 pixels per sample
constexpr int PSF_C = 49;        // PSF_CENTER
constexpr int GPAD_C = 99;       // gpad[GPAD_C + o] = g(o) for |o| <= 49, else 0
constexpr int GPAD_N = 2 * GPAD_C + 1;
constexpr int TAXELS = 4;
constexpr int TAXEL_C0 = 12;     // TAXEL_CENTER_0
constexpr int TAXEL_PITCH = 25;
constexpr int RT = 10;                           // tile rows (and the window length)
constexpr int CT = 4;                            // tile columns: one float4
constexpr int ROW_BLOCKS = HR / RT;              // 10
constexpr int COL_TILES = HR / CT;               // 25
constexpr int NTILES = ROW_BLOCKS * COL_TILES;   // 250
constexpr int THREADS = 256;                     // both kernels: one tile a thread
constexpr int WARPS = THREADS / 32;
constexpr int NOFF = HR;                         // correlation offsets -49..50 (g(50) = 0)
// contact-mask bits in chunks of 128 pixels (four words): 316 words, at
// least one past the last pixel's, so that a 10-bit window never reads past
constexpr int MASK_WORDS = 4 * ((NPIX + 127) / 128);
constexpr unsigned DEPTH_BYTES = NPIX * sizeof(float);  // 40,000: a multiple of 16

static_assert(THREADS >= NTILES, "one tile per thread");
static_assert(DEPTH_BYTES % 16 == 0, "bulk copies move multiples of 16 bytes");

// forward: dynamic shared memory layout (floats); buf first keeps it 16-byte aligned
constexpr int OFF_BUF = 0;                       // D, then T^T, then HR
constexpr int OFF_G = OFF_BUF + NPIX;            // gpad[199]
constexpr int OFF_U = OFF_G + 200;               // U[4][100]
constexpr int OFF_V = OFF_U + TAXELS * HR;       // V = U . HR as two halves' sums, [2][4][100]
constexpr int OFF_MASK = OFF_V + 2 * TAXELS * HR;  // contact-mask bits
constexpr int OFF_RED = OFF_MASK + MASK_WORDS + 2;  // block-reduction scratch
constexpr int OFF_MBAR = OFF_RED + 32;           // the mbarrier (8-byte aligned)
constexpr int SMEM_FLOATS = OFF_MBAR + 2;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);  // 47,008 B

// backward: dynamic shared memory layout (floats); every 128-bit access is aligned
constexpr int B_OFF_X = 0;                       // D, HR^T, G0^T, D again
constexpr int B_OFF_Y = B_OFF_X + NPIX;          // T^T, then Q
constexpr int B_OFF_P = B_OFF_Y + NPIX;          // correlation partials [25][100]
constexpr int B_OFF_G = B_OFF_P + COL_TILES * NOFF;  // gpad[199]
constexpr int B_OFF_U = B_OFF_G + 200;           // U[4][100]
constexpr int B_OFF_V = B_OFF_U + TAXELS * HR;   // V = U . HR
constexpr int B_OFF_W = B_OFF_V + TAXELS * HR;   // W = U . HR^T
constexpr int B_OFF_GU = B_OFF_W + TAXELS * HR;  // GU = gl . U
constexpr int B_OFF_GAM = B_OFF_GU + TAXELS * HR;         // gl[4][4]
constexpr int B_OFF_MASK = B_OFF_GAM + TAXELS * TAXELS;   // contact-mask bits
constexpr int B_OFF_RED = B_OFF_MASK + MASK_WORDS + 2;    // block-reduction scratch
constexpr int B_OFF_MBAR = B_OFF_RED + 32;                // the mbarrier
constexpr int B_SMEM_FLOATS = B_OFF_MBAR + 2;
constexpr size_t B_SMEM_BYTES = B_SMEM_FLOATS * sizeof(float);  // 98,672 B

static_assert(OFF_MBAR % 2 == 0 && B_OFF_MBAR % 2 == 0, "mbarriers are 8-byte aligned");
static_assert(B_OFF_U % 4 == 0 && B_OFF_GU % 4 == 0, "128-bit loads of U and GU");
static_assert(WARPS <= 32, "block_reduce scratch");
static_assert(2 * WARPS == TAXELS * TAXELS, "two LR outputs a warp");

// ------------------------------------------------------------ phase probe
// Built with -DTPSF_PROBE (tactilesr_torch/ops/cuda/probe.py), lane 0 of
// every warp writes clock64() at each PROBE(i) into g_probe[block][warp][i],
// and the SM and %globaltimer (ns) at the first and last PROBE into the last
// three slots; most phases end at a barrier, so their stamps mark the whole
// block.  Without the define PROBE compiles to nothing.
constexpr int PROBE_SLOTS = 16;
#ifdef TPSF_PROBE
__device__ long long* g_probe;
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}
// this warp's slots (lane 0 stamps) or null, read once: a stamp loads nothing
#define PROBE_INIT() \
  long long* const probe_slot = ((threadIdx.x & 31) == 0 && g_probe)                      \
      ? g_probe + ((size_t)blockIdx.x * WARPS + (threadIdx.x >> 5)) * PROBE_SLOTS : nullptr
#define PROBE(i)                                                          \
  do {                                                                    \
    if (probe_slot) {                                                     \
      const long long now = clock64();                                    \
      probe_slot[i] = now;                                                \
      if ((i) == 0) probe_slot[PROBE_SLOTS - 3] = sm_id();                \
      if ((i) == 0) probe_slot[PROBE_SLOTS - 2] = global_ns();            \
      if ((i) == PROBE_LAST) probe_slot[PROBE_SLOTS - 1] = global_ns();   \
    }                                                                     \
  } while (0)
#define PROBE_SYNC() __syncthreads()  // closes a phase that ends without a barrier
#else
#define PROBE_INIT() ((void)0)
#define PROBE(i) ((void)0)
#define PROBE_SYNC() ((void)0)
#endif

// ------------------------------------------------------------ TMA helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copies one depth map (DEPTH_BYTES, both addresses 16-byte aligned) from
// global to shared memory by one bulk copy; the mbarrier's phase completes
// when it has landed.  One thread calls this.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(DEPTH_BYTES) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(DEPTH_BYTES), "r"(smem_addr(bar)) : "memory");
}

// Waits until the mbarrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Copies one map (DEPTH_BYTES, both addresses 16-byte aligned) from shared
// to global memory in the background.  One thread calls this, and the same
// thread calls bulk_store_wait before the block may leave the source.
__device__ __forceinline__ void bulk_store(float* dst, const float* src) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(DEPTH_BYTES) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's earlier generic-proxy shared-memory accesses before
// later async-proxy (bulk copy) ones.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ shared routines
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

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Band steps of row block q, padded to a multiple of RT: 60 + 10 min(q, 9-q).
// Built with -DTPSF_PROBE_NO_BAND every loop runs no step: the results are
// wrong, and the time is that of everything else in the kernel.
__device__ __forceinline__ int band_steps(int q) {
#ifdef TPSF_PROBE_NO_BAND
  return 0 * q;
#else
  return 60 + RT * min(q, ROW_BLOCKS - 1 - q);
#endif
}

// Tile t -> row block q (rows 10q..10q+9, or offsets 10q-49..10q-40) and
// first column j0.  Pair p = t / 50 holds row blocks p and 9-p, whose bands
// have the same length, so a warp's lanes mostly run the same step count;
// within a pair the two row blocks alternate lane by lane, so that the 16
// lanes of a transposed store write two row blocks' columns of 8 rows.
__device__ __forceinline__ void tile_of(int t, int& q, int& j0) {
  const int p = t / (2 * COL_TILES), rem = t - 2 * COL_TILES * p;
  q = (rem & 1) ? ROW_BLOCKS - 1 - p : p;
  j0 = (rem >> 1) * CT;
}

// The thread's tile re-derived from %tid.x by a read the compiler cannot
// reuse, so that the coordinates hold no register across the long loops of
// the backward (at 128 registers ptxas would rather spill them).
__device__ __forceinline__ void my_tile(int& q, int& j0, int& i0) {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  tile_of(t, q, j0);
  i0 = q * RT;
}

// The contact-mask bits of pixels p0..p0+9, bit r for pixel p0 + r.
__device__ __forceinline__ unsigned mask_bits10(const unsigned* mask, int p0) {
  return __funnelshift_r(mask[p0 >> 5], mask[(p0 >> 5) + 1], p0 & 31);
}

// Buffers that transposed tile stores fill (T^T in the forward, T^T and Q
// in the backward) keep their even rows first: row j lies at
// prow(j) = (j % 2) * 50 + j / 2.  A store writes, for each of a tile's
// columns c, rows 4jt + c; with 100-float rows, the natural layout and
// consecutive jt on consecutive lanes put a warp's stores in two bank groups:
// storing a block's tiles took 2,200 wavefronts (640 at best).  This layout
// and the lane order of tile_of bring it to 660, at the price of 4,240
// rather than 3,200 wavefronts for a pass's band loads, which the FMAs hide.  A
// reader that walks rows 2a + u from an even start 2a still adds a constant
// per unrolled step: prow(2a + u) = a + prow(u).
__host__ __device__ constexpr int prow(int j) { return (j & 1) * (HR / 2) + (j >> 1); }

template <bool PERM>
__device__ __forceinline__ int row_of(int j) { return PERM ? prow(j) : j; }

// acc[r][c] = sum_k g(k - (i0 + r)) * src[k][j0 + c], i0 = 10q, over the
// band of rows i0..i0+9 padded by one zero-tap step (see the load model).
// Slot s of the tap window holds g(t) with t = s mod 10 relative to the
// block start: at step u of an unrolled block, row r reads slot (u - r) mod 10
// and slot u takes the newest tap.
// src's rows are in prow order when PERM.
template <bool PERM>
__device__ __forceinline__ void band_tile(const float* __restrict__ src,
                                          const float* __restrict__ gpad, int q, int j0,
                                          float acc[RT][CT]) {
  const int i0 = q * RT, n = band_steps(q);
  const int k0 = q < ROW_BLOCKS / 2 ? 0 : i0 - PSF_C - 1;  // even
  const float* gk = gpad + (GPAD_C + k0 - i0);  // gk[t] = g(k0 + t - i0)
  const float* row = src + row_of<PERM>(k0) * HR + j0;
  float w[RT];
  w[0] = 0.f;
#pragma unroll
  for (int s = 1; s < RT; ++s) w[s] = gk[s - RT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;
  for (int kb = 0; kb < n; kb += RT) {
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      w[u] = gk[kb + u];
      const float4 d = ld4(row + (PERM ? kb / 2 + prow(u) : kb + u) * HR);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float gr = w[(u - r + RT) % RT];
        acc[r][0] = fmaf(gr, d.x, acc[r][0]);
        acc[r][1] = fmaf(gr, d.y, acc[r][1]);
        acc[r][2] = fmaf(gr, d.z, acc[r][2]);
        acc[r][3] = fmaf(gr, d.w, acc[r][3]);
      }
    }
  }
}

// acc[r][c] = sum_i X[i][j0+c] * Y[i+o0+r][j0+c] over the rows where both
// indices lie in [0, HR), o0 = 10q - 49: ten diagonal offsets of the row
// correlation of X and Y, on four columns, padded like band_tile.  Y's rows
// slide through a window: at step u of an unrolled block, offset r reads
// slot (u + r) mod 10, and then slot u takes the row needed ten steps on.
// X's (Y's) rows are in prow order when PX (PY).
template <bool PX, bool PY>
__device__ __forceinline__ void diag_corr(const float* __restrict__ X, const float* __restrict__ Y,
                                          int q, int j0, float acc[RT][CT]) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int o0 = q * RT - PSF_C, n = band_steps(q);
  const int i_lo = max(0, -o0 - (RT - 1));  // even
  const int ybase = i_lo + o0;  // odd, >= -9; the row in slot 0 at the start
  const float* xrow = X + row_of<PX>(i_lo) * HR + j0;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;
  float4 y[RT];
#pragma unroll
  for (int s = 0; s < RT; ++s) {
    const int k = ybase + s;
    y[s] = (k >= 0 && k < HR) ? ld4(Y + row_of<PY>(k) * HR + j0) : zero;
  }
  for (int ib = 0; ib < n; ib += RT) {
#pragma unroll
    for (int u = 0; u < RT; ++u) {
      const float4 x = ld4(xrow + (PX ? ib / 2 + prow(u) : ib + u) * HR);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 yr = y[(u + r) % RT];
        acc[r][0] = fmaf(x.x, yr.x, acc[r][0]);
        acc[r][1] = fmaf(x.y, yr.y, acc[r][1]);
        acc[r][2] = fmaf(x.z, yr.z, acc[r][2]);
        acc[r][3] = fmaf(x.w, yr.w, acc[r][3]);
      }
      const int k = ybase + ib + u + RT;  // >= 1; ybase + ib + RT - 1 is even
      const int yrow = PY ? (ybase + ib + RT - 1) / 2 + prow(1 + u) : k;
      y[u] = k < HR ? ld4(Y + yrow * HR + j0) : zero;
    }
  }
}

// Column c of a tile, 10 consecutive floats at p (8-byte aligned), as float2s.
__device__ __forceinline__ void store_col(float* p, const float acc[RT][CT], int c) {
#pragma unroll
  for (int r = 0; r < RT; r += 2) *reinterpret_cast<float2*>(p + r) = make_float2(acc[r][c], acc[r + 1][c]);
}

// gpad and U for this sample's beta and m (expf, no fast math)
__device__ __forceinline__ void psf_and_mask_taps(float* gpad, float* U, float beta, float m,
                                                  float c_psf, float c_mask) {
  const int tid = threadIdx.x;
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
}

// Bit i of the low byte of x moved to bit 4i.
__device__ __forceinline__ unsigned spread_nibbles(unsigned x) {
  x &= 0xffu;
  x = (x | (x << 12)) & 0x000f000fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// The map's threshold max(d) - disturbance and its contact-mask bits
// (pixel p -> mask[p / 32] bit p % 32) from one read of the map in buf.  The
// map goes in chunks of 128 pixels, chunk ch to warp ch % 8, one 128-bit
// word a lane; each thread keeps its ten words in registers across the block
// max, then a warp makes one ballot per component of a chunk, and word k of
// the chunk interleaves bits 8k..8k+7 of the four.
constexpr int MASK_CHUNKS = MASK_WORDS / 4;                      // 79
constexpr int CHUNKS_PER_WARP = (MASK_CHUNKS + WARPS - 1) / WARPS;  // 10
__device__ __forceinline__ void max_and_mask(const float* buf, float* red, float disturbance,
                                             unsigned* mask) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4 v[CHUNKS_PER_WARP];
  float dmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < CHUNKS_PER_WARP; ++i) {
    const int p = 128 * (warp + WARPS * i) + 4 * lane;
    v[i] = p < NPIX ? ld4(buf + p) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    dmax = fmaxf(dmax, fmaxf(fmaxf(v[i].x, v[i].y), fmaxf(v[i].z, v[i].w)));
  }
  const float thr = block_reduce<true>(dmax, red) - disturbance;
#pragma unroll
  for (int i = 0; i < CHUNKS_PER_WARP; ++i) {
    const int ch = warp + WARPS * i;
    if (ch < MASK_CHUNKS) {  // the same for the whole warp
      const unsigned bx = __ballot_sync(0xffffffffu, v[i].x > thr);
      const unsigned by = __ballot_sync(0xffffffffu, v[i].y > thr);
      const unsigned bz = __ballot_sync(0xffffffffu, v[i].z > thr);
      const unsigned bw = __ballot_sync(0xffffffffu, v[i].w > thr);
      if (lane < 4) {
        const int sh = 8 * lane;
        mask[4 * ch + lane] = spread_nibbles(bx >> sh) | spread_nibbles(by >> sh) << 1 |
                              spread_nibbles(bz >> sh) << 2 | spread_nibbles(bw >> sh) << 3;
      }
    }
  }
}

// sum_x X[x] Y[x] over x < HR by one warp, in a fixed order; every lane
// gets it.
__device__ __forceinline__ float warp_dot(const float* X, const float* Y) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int x = lane; x < HR; x += 32) s = fmaf(X[x], Y[x], s);
  return warp_sum(s);
}

// ---------------------------------------------------------------- forward
__global__ void __launch_bounds__(THREADS, 3)
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
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + OFF_MBAR);

  [[maybe_unused]] constexpr int PROBE_LAST = 7;
  PROBE_INIT();
  PROBE(0);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float alpha = abm[3 * b + 0];
  const float beta = abm[3 * b + 1];
  const float m = abm[3 * b + 2];
  const bool active = tid < NTILES;
  int q, j0;
  tile_of(tid, q, j0);
  const int i0 = q * RT;

  // 1. depth -> buf by one bulk copy, overlapped with gpad and U; the max
  //    and the mask bits once it has landed
  if (tid == 0) mbar_init(mbar);
  __syncthreads();
  if (tid == 0) bulk_load(buf, depth + b * NPIX, mbar);
  psf_and_mask_taps(gpad, U, beta, m, c_psf, c_mask);
  mbar_wait(mbar, 0);
  __syncthreads();  // the map has landed; gpad and U are published
  PROBE(1);
  max_and_mask(buf, red, disturbance, mask);
  PROBE_SYNC();
  PROBE(2);

  // 2. T = A . D, kept in registers, then stored transposed over D
  float acc[RT][CT];
  if (active) band_tile<false>(buf, gpad, q, j0, acc);
  __syncthreads();  // every read of D is done
  if (active) {
#pragma unroll
    for (int c = 0; c < CT; ++c) store_col(buf + prow(j0 + c) * HR + i0, acc, c);  // T^T[j0+c][i0..]
  }
  __syncthreads();
  PROBE(3);

  // 3. the same routine on T^T gives HR0^T / alpha: tile (i0+r, j0+c) is
  //    pixel (j0+c, i0+r) of HR0
  if (active) band_tile<true>(buf, gpad, q, j0, acc);

  //    Second max over where(mask, 0, HR0)
  float second = -INFINITY;
  if (active) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const unsigned bits = mask_bits10(mask, (j0 + c) * HR + i0);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float v = alpha * acc[r][c];
        acc[r][c] = v;
        second = fmaxf(second, (bits >> r) & 1u ? 0.f : v);
      }
    }
  }
  second = block_reduce<true>(second, red);  // its first barrier: every T^T read is done
  PROBE(4);

  // 4. fixup; HR goes row-major into buf
  float hsum = 0.f;
  if (active) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const unsigned bits = mask_bits10(mask, (j0 + c) * HR + i0);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if ((bits >> r) & 1u) acc[r][c] = second;
        hsum += acc[r][c];
      }
      store_col(buf + (j0 + c) * HR + i0, acc, c);
    }
  }
  fence_proxy_async();  // HR in buf is read next by the bulk store
  hsum = block_reduce<false>(hsum, red);  // its barriers publish the final HR
  PROBE(5);

  // 5. HR to global by one bulk store in the background; V = U . HR (4 x 100)
  //    as two halves of the sum over y, thread (x, h) for h = 0, 1
  if (tid == 0) bulk_store(hr_out + b * NPIX, buf);
  constexpr int Y_SPLIT = 52;  // halves of the sum over y, each a multiple of 4
  if (tid < 2 * HR) {
    const int x = tid % HR, h = tid / HR;
    float a[TAXELS] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int y = h * Y_SPLIT; y < (h ? HR : Y_SPLIT); y += 4) {
      const float v0 = buf[y * HR + x], v1 = buf[(y + 1) * HR + x];
      const float v2 = buf[(y + 2) * HR + x], v3 = buf[(y + 3) * HR + x];
#pragma unroll
      for (int t = 0; t < TAXELS; ++t) {
        const float4 u = ld4(U + t * HR + y);
        a[t] = fmaf(u.w, v3, fmaf(u.z, v2, fmaf(u.y, v1, fmaf(u.x, v0, a[t]))));
      }
    }
#pragma unroll
    for (int t = 0; t < TAXELS; ++t) V[(h * TAXELS + t) * HR + x] = a[t];
  }
  __syncthreads();
  PROBE(6);

  // 6. LR = (V . U^T - mn * sum(HR)) / (1 - mn) * scale: warp w gives
  //    outputs 2w and 2w + 1
  const int lane = tid & 31, warp = tid >> 5;
  const float mn = expf(-100.0f / m);
#pragma unroll 1
  for (int o = 2 * warp; o < 2 * warp + 2; ++o) {
    const int a = o / TAXELS, c = o % TAXELS;
    float s = 0.f;
#pragma unroll
    for (int x = lane; x < HR; x += 32) s = fmaf(V[a * HR + x] + V[(TAXELS + a) * HR + x], U[c * HR + x], s);
    s = warp_sum(s);
    if (lane == 0) lr_out[b * TAXELS * TAXELS + o] = (s - mn * hsum) / (1.0f - mn) * degrade_scale;
  }
  if (tid == 0) bulk_store_wait();  // buf stays until the store has read it
  PROBE(PROBE_LAST);
}

// ---------------------------------------------------------------- backward
__global__ void __launch_bounds__(THREADS, 2)
tpsf_physics_bwd_kernel(const float* __restrict__ depth, const float* __restrict__ abm,
                        const float* __restrict__ g_lr, const float* __restrict__ g_hr,
                        float* __restrict__ g_abm, float* __restrict__ g_depth,
                        float c_psf, float c_mask, float disturbance, float degrade_scale) {
  extern __shared__ __align__(16) float smem[];
  float* bufX = smem + B_OFF_X;
  float* bufY = smem + B_OFF_Y;
  float* part = smem + B_OFF_P;
  float* gpad = smem + B_OFF_G;
  float* U = smem + B_OFF_U;
  float* V = smem + B_OFF_V;
  float* W = smem + B_OFF_W;
  float* GU = smem + B_OFF_GU;
  float* gam = smem + B_OFF_GAM;
  unsigned* mask = reinterpret_cast<unsigned*>(smem + B_OFF_MASK);
  float* red = smem + B_OFF_RED;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + B_OFF_MBAR);

  [[maybe_unused]] constexpr int PROBE_LAST = 9;
  PROBE_INIT();
  PROBE(0);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* dsrc = depth + b * NPIX;
  const float alpha = abm[3 * b + 0];
  const float beta = abm[3 * b + 1];
  const float m = abm[3 * b + 2];
  const float mn = expf(-100.0f / m);
  const float c = degrade_scale / (1.0f - mn);
  const bool active = tid < NTILES;
  int q, j0, i0;  // tile: rows i0 = 10q.. and columns j0..j0+3, or offsets 10q-49.. on them

  // 1. depth -> X by one bulk copy, overlapped with gpad, U and the LR
  //    cotangent; then the max and the mask bits; GU = gl . U
  if (tid == 0) mbar_init(mbar);
  __syncthreads();
  if (tid == 0) bulk_load(bufX, dsrc, mbar);
  psf_and_mask_taps(gpad, U, beta, m, c_psf, c_mask);
  if (tid < TAXELS * TAXELS) gam[tid] = g_lr ? g_lr[b * TAXELS * TAXELS + tid] : 0.f;
  mbar_wait(mbar, 0);
  __syncthreads();  // the map has landed; gpad, U and gl are published
  PROBE(1);
  max_and_mask(bufX, red, disturbance, mask);
  for (int p = tid; p < TAXELS * HR; p += THREADS) {
    const int a = p / HR, y = p % HR;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < TAXELS; ++k) s = fmaf(gam[a * TAXELS + k], U[k * HR + y], s);
    GU[p] = s;
  }
  __syncthreads();  // mask bits and GU published
  PROBE(2);

  // 2. T = A . D, stored transposed into Y
  float acc[RT][CT];
  my_tile(q, j0, i0);
  if (active) {
    band_tile<false>(bufX, gpad, q, j0, acc);
#pragma unroll
    for (int c2 = 0; c2 < CT; ++c2) store_col(bufY + prow(j0 + c2) * HR + i0, acc, c2);
  }
  __syncthreads();  // T^T published; every read of D is done
  PROBE(3);

  // 3. acc = HR0^T / alpha: acc[r][c] is pixel (j0+c, i0+r) of HR0 / alpha.
  //    Second max over where(mask, 0, HR0), then HR^T over D in X and
  //    S = sum(HR)
  if (active) band_tile<true>(bufY, gpad, q, j0, acc);
  unsigned bits[CT];
#pragma unroll
  for (int c2 = 0; c2 < CT; ++c2) bits[c2] = active ? mask_bits10(mask, (j0 + c2) * HR + i0) : 0u;
  float second = -INFINITY;
  if (active) {
#pragma unroll
    for (int c2 = 0; c2 < CT; ++c2)
#pragma unroll
      for (int r = 0; r < RT; ++r) second = fmaxf(second, (bits[c2] >> r) & 1u ? 0.f : alpha * acc[r][c2]);
  }
  second = block_reduce<true>(second, red);
  float hsum = 0.f;
  if (active) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float o[CT];
#pragma unroll
      for (int c2 = 0; c2 < CT; ++c2) {
        o[c2] = (bits[c2] >> r) & 1u ? second : alpha * acc[r][c2];
        hsum += o[c2];
      }
      *reinterpret_cast<float4*>(bufX + (i0 + r) * HR + j0) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  hsum = block_reduce<false>(hsum, red);  // publishes HR^T
  PROBE(4);

  // V[t][x] = sum_y U[t][y] HR^T[x][y] (threads 0..99, 128-bit along y);
  // W[t][y] = sum_x U[t][x] HR^T[x][y] (threads 128..227)
  if (tid < HR) {
    float s[TAXELS] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 5
    for (int y = 0; y < HR; y += 4) {
      const float4 h = ld4(bufX + tid * HR + y);
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
#pragma unroll 5
    for (int x = 0; x < HR; x += 4) {
      const float h0 = bufX[x * HR + y], h1 = bufX[(x + 1) * HR + y];
      const float h2 = bufX[(x + 2) * HR + y], h3 = bufX[(x + 3) * HR + y];
#pragma unroll
      for (int t = 0; t < TAXELS; ++t) {
        const float4 u = ld4(U + t * HR + x);
        s[t] = fmaf(u.w, h3, fmaf(u.z, h2, fmaf(u.y, h1, fmaf(u.x, h0, s[t]))));
      }
    }
#pragma unroll
    for (int t = 0; t < TAXELS; ++t) W[t * HR + y] = s[t];
  }
  __syncthreads();  // V and W published; every read of HR^T is done
  PROBE(5);

  // dm's terms: the 400 of the mask width (threads), the 16 of mn (two
  // a warp, by warp_dot); G0^T over HR^T in X and dalpha (tiles)
  float dm_part = 0.f;
  const float m2 = m * m;
  for (int p = tid; p < TAXELS * HR; p += THREADS) {
    const int t = p / HR, x = p % HR;
    float gu = 0.f;
#pragma unroll
    for (int k = 0; k < TAXELS; ++k)
      gu = fmaf(gam[t * TAXELS + k], W[k * HR + x], fmaf(gam[k * TAXELS + t], V[k * HR + x], gu));
    const float dx = (float)x - (float)(t * TAXEL_PITCH + TAXEL_C0);
    dm_part += c * gu * U[p] * (c_mask * (dx * dx) / m2);
  }
#pragma unroll 1
  for (int g = 2 * (tid >> 5); g < 2 * (tid >> 5) + 2; ++g) {
    const float t2 = warp_dot(V + (g / TAXELS) * HR, U + (g % TAXELS) * HR);  // (V U^T)[a][k]
    if ((tid & 31) == 0)
      dm_part += gam[g] * (degrade_scale * (t2 - hsum) / ((1.0f - mn) * (1.0f - mn))) * (mn * 100.0f / m2);
  }
  float gsum = 0.f;
#pragma unroll
  for (int g = 0; g < TAXELS * TAXELS; ++g) gsum += gam[g];
  const float g_off = c * mn * gsum;
  float da_part = 0.f;
  if (active) {
    // G^T[i0+r][j0+c] = c sum_a U[a][j0+c] GU[a][i0+r] - c mn sum(gl) + gh[j0+c][i0+r]
    float4 uj[TAXELS];
#pragma unroll
    for (int a = 0; a < TAXELS; ++a) uj[a] = ld4(U + a * HR + j0);
#pragma unroll
    for (int rr = 0; rr < RT; rr += 2) {  // two rows at a time: gh comes as float2 columns
      float2 gh[CT];
#pragma unroll
      for (int c2 = 0; c2 < CT; ++c2)
        gh[c2] = g_hr ? *reinterpret_cast<const float2*>(g_hr + b * NPIX + (j0 + c2) * HR + i0 + rr)
                      : make_float2(0.f, 0.f);
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int r = rr + r2;
        float gi[TAXELS];
#pragma unroll
        for (int a = 0; a < TAXELS; ++a) gi[a] = GU[a * HR + i0 + r];
        float o[CT];
#pragma unroll
        for (int c2 = 0; c2 < CT; ++c2) {
          float gt = 0.f;
#pragma unroll
          for (int a = 0; a < TAXELS; ++a) gt = fmaf(gi[a], lane4(uj[a], c2), gt);
          o[c2] = (bits[c2] >> r) & 1u ? 0.f : c * gt - g_off + (r2 ? gh[c2].y : gh[c2].x);
          da_part = fmaf(o[c2], acc[r][c2], da_part);
        }
        *reinterpret_cast<float4*>(bufX + (i0 + r) * HR + j0) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
  const float d_alpha = block_reduce<false>(da_part, red);
  const float d_m = block_reduce<false>(dm_part, red);  // G0^T published
  if (g_abm && tid == 0) {
    g_abm[3 * b + 0] = d_alpha;
    g_abm[3 * b + 2] = d_m;
  }
  PROBE(6);

  // 4. h2 = corr(G0^T, T^T) for offsets 10q-49..10q-40 on columns j0..j0+3,
  //    summed over the columns into the tile's partials [column tile][offset]
  if (active) {
    diag_corr<false, true>(bufX, bufY, q, j0, acc);
    my_tile(q, j0, i0);
    float* tp = part + (j0 / CT) * NOFF + i0;
#pragma unroll
    for (int r = 0; r < RT; ++r) tp[r] = (acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]);
    // 5. Q^T = A . G0^T (A is symmetric); tile (i0+r, j0+c) is Q[j0+c][i0+r]
    band_tile<false>(bufX, gpad, q, j0, acc);
    my_tile(q, j0, i0);
  }
  // every read of X (G0^T) and Y (T^T) is done: D comes back into X from L2
  // while Q goes into Y
  fence_proxy_async();
  __syncthreads();
  PROBE(7);
  if (tid == 0) bulk_load(bufX, dsrc, mbar);
  if (active) {
#pragma unroll
    for (int c2 = 0; c2 < CT; ++c2) store_col(bufY + prow(j0 + c2) * HR + i0, acc, c2);
  }
  mbar_wait(mbar, 1);
  __syncthreads();  // Q published, D back in X
  PROBE(8);

  // 6. h1 = corr(Q, D), added to the tile's partials
  if (active) {
    diag_corr<true, false>(bufY, bufX, q, j0, acc);
    my_tile(q, j0, i0);
    float* tp = part + (j0 / CT) * NOFF + i0;
#pragma unroll
    for (int r = 0; r < RT; ++r) tp[r] += (acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]);
    // 7. gdepth = alpha A . Q
    if (g_depth) {
      band_tile<true>(bufY, gpad, q, j0, acc);
      my_tile(q, j0, i0);
#pragma unroll
      for (int r = 0; r < RT; ++r)
        *reinterpret_cast<float4*>(g_depth + b * NPIX + (i0 + r) * HR + j0) =
            make_float4(alpha * acc[r][0], alpha * acc[r][1], alpha * acc[r][2], alpha * acc[r][3]);
    }
  }

  // 8. dbeta: offset o = t - 49 weighs h1 + h2 by dg/dbeta = g(o) 2 C_PSF o^2 / beta^3
  float db_part = 0.f;
  __syncthreads();  // partials published
  if (tid < NOFF) {
    float hs = 0.f;
#pragma unroll 5
    for (int k = 0; k < COL_TILES; ++k) hs += part[k * NOFF + tid];
    const float of = (float)(tid - PSF_C);
    const float beta3 = beta * beta * beta;
    db_part = hs * gpad[GPAD_C + tid - PSF_C] * (2.0f * c_psf * of * of / beta3);
  }
  const float d_beta = alpha * block_reduce<false>(db_part, red);
  if (g_abm && tid == 0) g_abm[3 * b + 1] = d_beta;
  PROBE(PROBE_LAST);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename K>
int kernel_info(K kernel, size_t smem, int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = THREADS;
  out[2] = (int)smem;
  out[3] = (int)attr.sharedSizeBytes;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return (int)cudaSuccess;
}

}  // namespace

// Launch over B samples on `stream`; returns the cudaError_t (0 = success).
// depth (B,100,100), abm (B,3), hr (B,100,100), lr (B,4,4): contiguous f32
// on the current device; depth and hr 16-byte aligned (the bulk copy needs
// it).  B == 0 launches nothing.
extern "C" int tpsf_physics_launch(const float* depth, const float* abm, float* hr,
                                   float* lr, int batch, float c_psf, float c_mask,
                                   float disturbance, float degrade_scale,
                                   void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  cudaError_t err = allow_smem(tpsf_physics_kernel, SMEM_BYTES);
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
  cudaError_t err = allow_smem(tpsf_physics_bwd_kernel, B_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  tpsf_physics_bwd_kernel<<<batch, THREADS, B_SMEM_BYTES, (cudaStream_t)stream>>>(
      depth, abm, g_lr, g_hr, g_abm, g_depth, c_psf, c_mask, disturbance, degrade_scale);
  return (int)cudaGetLastError();
}

// Occupancy and resources of kernel `which` (0 = forward, 1 = backward) on
// the current device: out[0..5] = resident blocks per SM, threads per block,
// dynamic and static shared bytes, registers per thread, local (spill)
// bytes per thread.  Returns the cudaError_t.
extern "C" int tpsf_kernel_info(int which, int* out) {
  if (which == 0) return kernel_info(tpsf_physics_kernel, SMEM_BYTES, out);
  if (which == 1) return kernel_info(tpsf_physics_bwd_kernel, B_SMEM_BYTES, out);
  return (int)cudaErrorInvalidValue;
}

#ifdef TPSF_PROBE
// Where the probe build's kernels write their stamps (null: nowhere).
extern "C" int tpsf_set_probe(long long* stamps) {
  return (int)cudaMemcpyToSymbol(g_probe, &stamps, sizeof(stamps));
}
#endif

extern "C" const char* tpsf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
