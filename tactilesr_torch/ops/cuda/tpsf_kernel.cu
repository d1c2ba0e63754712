// Fused tPSF physics for Hopper (sm_90a): an f32 forward and backward
// kernel and a bf16 tensor-core forward in two forms, one thread block per
// sample.
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
// tpsf_physics_bf16_kernel and tpsf_physics_bf16x3_kernel replace the same
// Pallas kernel at precision=DEFAULT and HIGH (physics_precision default and
// high): the function above, with each of _sample_body's four dots (A . D,
// T . A^T, U . HR, (U HR) . U^T) rounding its operands to bf16 and summing
// in f32 -- one pass (hi . hi) or three (hi . hi + hi . lo + lo . hi, with
// x = hi + lo split in bf16; lo . lo is dropped, as in Precision.HIGH).  T
// and U HR are f32 sums split only as the next product's operand; the
// mask, the second max, sum(HR) and alpha see f32.  Their plain version is
// physics_plain(..., precision).
//
// What bounds them: bytes.  The two banded products are 3.06 MFLOP per
// sample, which the bf16 tensor cores (989 TFLOP/s dense) do in 3.1 ns a
// pass (9.3 ns for the three-pass kernel, which issues three times the
// one-pass kernel's products); the 80,076 B of depth in and HR, LR and abm
// out take 23.9 ns at 3.35 TB/s.  Both kernels run one body,
// tpsf_physics_bf16_tiled<PLANES>, with PLANES = 1 or 2 bf16 planes per
// operand; every PLANES == 2 addition sits under if constexpr, so the
// one-pass kernel compiles to the same code with or without it.  The
// body keeps the products off the CUDA cores: one block of 8 warps per
// sample, depth by a TMA bulk copy (the mask reads it in f32), the maps
// padded to 112 x 112 in bf16, and seven warps that each own a 16-row
// stripe of T = A . D and then of HR0 = T . A^T, mma.sync m16n8k16 (bf16,
// f32 accumulators in registers) on operands loaded by ldmatrix, skipping
// the 16x16 blocks outside A's band; with two planes each step issues
// hi . hi, hi . lo and lo . hi into the same accumulators.  T goes back to
// shared memory in bf16 planes (split where the TPU splits it) and HR0
// stays f32 in registers.  So the products are a small part of a block,
// whose latency, not its bytes, sets its time (the 256 samples of a
// training or generation batch fit in one wave); the design is shaped
// around the time outside the products:
//   - A(beta) is Toeplitz, A[i][k] = g(k - i), so a 16x16 block of it
//     depends only on its block offset kt - mt, and only offsets -4..4 are
//     non-zero: nine 16x16 tiles a plane (6.9 KB, 1,152 pair stores)
//     replace a 112 x 112 plane (26.9 KB, 6,272 pair stores).  Product 1
//     reads tile kt - mt as its row operand, product 2 tile kt - np as its
//     column operand (A^T's block (kt, np) is A's block (np, kt), read as
//     stored).  The padding is no longer zero in A: A's padded rows and
//     columns hold taps, in the hi and in the lo tiles, so T's padded rows
//     and HR0's padded rows and columns are garbage (finite).  The result
//     stays exact because D's padded rows and columns are zero in both
//     planes, which makes T's padded columns zero in both, so every
//     contraction over k >= 100 (hi . hi, hi . lo, lo . hi) adds nothing,
//     and because the epilogue reads only i, j < 100.
//   - The epilogue has one block reduction: each thread gathers the contact
//     bits of its 52 places once into two registers, then takes the second
//     max over the non-contact HR0 (the contact pixels' zeros are its
//     floor), their sum and the contact count together; sum(HR) = that sum
//     + count * second.  HR goes straight from the mma's C registers to
//     global memory (a quad of lanes writes 32 contiguous bytes of a row),
//     and V = U . HR runs on the tensor cores from the same registers:
//     movmatrix transposes the C fragment of an 8x8 block (of HR's hi, and
//     of its lo) into the B fragment, and each warp stores its stripe's
//     partial of V, which LR sums in stripe order.  No atomics: the results
//     are bitwise repeatable.
//   - Shared memory is one region that holds the depth map in f32, then
//     D's planes in bf16 (written from the registers the mask read the map
//     into), then T's (written once every warp has read D, from the
//     accumulators), then V's partials: 40,000 B with one plane, 53,760 B
//     (two 26,880 B planes) with two.  Beside it the tiles, gpad, U's
//     planes, the mask bits, the reduction scratch and the mbarrier: 50,976
//     B a block in the one-pass kernel, 73,248 B in the three-pass one.
//   - Registers then set the blocks per SM.  Nothing is computed for
//     columns 104..111 (T's are zero, HR0's unread: 52 accumulators, not
//     56), the mask bits are kept in the order the ballots give them, so
//     that a thread gathers a row's 26 bits with two 8-byte loads and a few
//     shifts, and the epilogue keeps HR0 only at the non-contact pixels
//     (zero elsewhere), so the fixup is one select an element.  The
//     one-pass kernel fits 80 registers, three blocks per SM.  The
//     three-pass kernel holds a lo fragment beside each hi one; its
//     product loops take B's hi and lo fragments one 8-column n-tile at a
//     time (ldmatrix .x2: four registers, not the eight of two .x4 loads),
//     so it fits 80 registers too, and three blocks per SM (3 x 73,248 B of
//     shared memory fit an SM's 228 KB).  Built for two blocks per SM it
//     took 128 registers and ran B=8192 about 15% slower on an H100.
//     Fourteen warps of half stripes (448 threads, 72 registers, two blocks
//     per SM) measured slower on an H100 for the one-pass kernel: a product
//     phase did not shorten with its warps' share of the tiles.
//
// Build: nvcc -O3 -gencode arch=compute_90a,code=sm_90a -std=c++17 -shared
//        -Xcompiler -fPIC -Xptxas -v  (done by tactilesr_torch/ops/cuda/__init__.py)

#include <cuda_bf16.h>
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

// ------------------------------------------------------------ bf16 forward
// tpsf_physics_bf16_kernel (one pass) and tpsf_physics_bf16x3_kernel (three
// passes): the function of tpsf_physics_kernel with the products of
// _sample_body at precision=DEFAULT and HIGH (see the file's header), one
// body templated on PLANES, the bf16 planes each operand is split into: 1
// (hi = bf16(x)) or 2 (hi and lo = bf16(x - hi)).  The maps are padded to
// MP = 112 (seven 16-row tiles) and held in shared memory as bf16 with a
// row stride of LDB = 120 elements (240 B: the eight rows of an ldmatrix
// fall on eight different 16-byte bank groups), a map's lo plane one plane
// (BMAT elements) after its hi plane.  A(beta) is Toeplitz: A[i][k] =
// g(k - i), so the 16x16 block (mt, kt) of the padded A is one of nine
// tiles, by its offset o = kt - mt in -4..4, tile[r][c] = g(16 o + c - r);
// |o| >= 5 is zero.  With two planes the nine lo tiles follow the nine hi
// tiles.
constexpr int MP = 112;
constexpr int MT = MP / 16;       // 16-row (and 16-deep) tiles of a padded map
constexpr int LDB = 120;          // bf16 row stride of a padded map
constexpr int BMAT = MP * LDB;    // bf16 elements of one padded map plane (26,880 B)
constexpr int BAND_TILES = 4;     // A is zero on 16x16 blocks more than 4 apart (|k - i| >= 65)
constexpr int LDT = 24;                        // bf16 row stride of a tile (48 B: an ldmatrix's
                                               // eight rows on eight bank groups)
constexpr int TILE = 16 * LDT;                 // bf16 elements a tile
constexpr int NOFFS = 2 * BAND_TILES + 1;      // nine tiles
constexpr int NTM = 13;                        // 8-column n-tiles that hold map columns (< 100)
constexpr int VLD = NTM * 8;                   // V partial row
constexpr int RED3 = 32;                       // reduction scratch: max, sum, count per warp

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// Dynamic shared memory of the bf16 kernels, in bytes.  R0 holds the depth
// map in f32 (the bulk copy's target), then D's PLANES planes in bf16
// (written from the registers the mask read the map into), then T's, then
// the seven warps' partials of V = U . HR.
template <int PLANES>
struct TiledSmem {
  static constexpr size_t R0 = 0;
  static constexpr size_t REGION = cmax(DEPTH_BYTES, size_t(PLANES) * BMAT * 2);
  static constexpr size_t TILES = R0 + REGION;                       // A's tiles, bf16 [PLANES][9]
  static constexpr size_t G = TILES + PLANES * NOFFS * TILE * 2;     // gpad f32 [200]
  static constexpr size_t U = G + 200 * 4;                           // U's planes, f32 [PLANES][4][100]
  static constexpr size_t MASK = U + PLANES * TAXELS * HR * 4;       // contact-mask bits
  static constexpr size_t RED = MASK + (MASK_WORDS + 2) * 4;         // reduction scratch
  static constexpr size_t MBAR = RED + 3 * RED3 * 4;                 // the mbarrier
  static constexpr size_t BYTES = MBAR + 8;
  static_assert(size_t(MT) * TAXELS * VLD * 4 <= REGION, "V's partials fit in the region");
  static_assert(TILES % 16 == 0 && (TILE * 2) % 16 == 0 && (BMAT * 2) % 16 == 0,
                "ldmatrix rows are 16-byte aligned");
  static_assert(MASK % 8 == 0, "row_contact_bits loads two words at once");
  static_assert(MBAR % 8 == 0, "mbarriers are 8-byte aligned");
};
constexpr size_t BF16_SMEM_BYTES = TiledSmem<1>::BYTES;    // 50,976 B: three blocks per SM
constexpr size_t BF16X3_SMEM_BYTES = TiledSmem<2>::BYTES;  // 73,248 B: three blocks fit an SM
static_assert(TiledSmem<1>::REGION == DEPTH_BYTES, "one plane of D and T fits where the map landed");
static_assert(BF16_SMEM_BYTES == 50976 && BF16X3_SMEM_BYTES == 73248, "the layouts of the header note");

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// (a, b) rounded to bf16, a in the low half: the order of a fragment's pair
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The lo parts of (a, b), bf16(x - bf16(x)), packed as pack_bf16 packs them
__device__ __forceinline__ uint32_t pack_bf16_lo(float a, float b) {
  return pack_bf16(a - bf16_round(a), b - bf16_round(b));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (trans: each matrix transposed on the way).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)) : "memory");
}

// Two 8x8 bf16 matrices: lanes 0..15 give the addresses (lane l, row l % 8
// of matrix l / 8).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const __nv_bfloat16* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col) on the tensor cores
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One product step at the kernel's precision: hi.hi, and with two planes
// also hi.lo and lo.hi into the same accumulators, in that order (the HIGH
// split; lo.lo is dropped, as there).  al, bl0 and bl1 are read only with
// two planes.
template <int PLANES>
__device__ __forceinline__ void mma_step(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                         uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_bf16(c, ah, bh0, bh1);
  if constexpr (PLANES == 2) {
    mma_bf16(c, ah, bl0, bl1);
    mma_bf16(c, al, bh0, bh1);
  }
}

// Block offset o's tile (of the hi set; the lo set starts NOFFS tiles on).
__device__ __forceinline__ const __nv_bfloat16* a_tile(const __nv_bfloat16* tiles, int o) {
  return tiles + (o + BAND_TILES) * TILE;
}

// The 8x8 bf16 matrix whose fragment (row lane / 4, columns 2 (lane % 4) and
// + 1) this lane holds, transposed: the lane gets the same places of the
// transpose.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The max and the contact-mask bits of the f32 map in r0, then D's planes
// over it, padded to MP x MP with zeros, written from the registers the map
// was read into.  The caller publishes D and the mask.  The map goes in
// chunks of 128 pixels as in max_and_mask, but the bits stay in ballot
// order: pixel p = 128 ch + 4 l + c is bit l of word 4 ch + c
// (row_contact_bits reads them).
template <int PLANES>
__device__ __forceinline__ void mask_and_d(const float* r0, float* red, float disturbance,
                                           unsigned* mask, __nv_bfloat16* Dm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4 v[CHUNKS_PER_WARP];
  float dmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < CHUNKS_PER_WARP; ++i) {
    const int p = 128 * (warp + WARPS * i) + 4 * lane;
    v[i] = p < NPIX ? ld4(r0 + p) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    dmax = fmaxf(dmax, fmaxf(fmaxf(v[i].x, v[i].y), fmaxf(v[i].z, v[i].w)));
  }
  const float thr = block_reduce<true>(dmax, red) - disturbance;  // its barriers: r0 is read
#pragma unroll
  for (int i = 0; i < CHUNKS_PER_WARP; ++i) {
    const int ch = warp + WARPS * i, p = 128 * ch + 4 * lane;
    if (ch < MASK_CHUNKS) {  // the same for the whole warp
      const unsigned bx = __ballot_sync(0xffffffffu, v[i].x > thr);
      const unsigned by = __ballot_sync(0xffffffffu, v[i].y > thr);
      const unsigned bz = __ballot_sync(0xffffffffu, v[i].z > thr);
      const unsigned bw = __ballot_sync(0xffffffffu, v[i].w > thr);
      if (lane < 4) mask[4 * ch + lane] = lane == 0 ? bx : lane == 1 ? by : lane == 2 ? bz : bw;
    }
    if (p < NPIX) {  // four pixels of one row (HR is a multiple of 4): 8 bytes a plane
      *reinterpret_cast<uint2*>(Dm + (p / HR) * LDB + p % HR) =
          make_uint2(pack_bf16(v[i].x, v[i].y), pack_bf16(v[i].z, v[i].w));
      if constexpr (PLANES == 2)
        *reinterpret_cast<uint2*>(Dm + BMAT + (p / HR) * LDB + p % HR) =
            make_uint2(pack_bf16_lo(v[i].x, v[i].y), pack_bf16_lo(v[i].z, v[i].w));
    }
  }
  // the padding: columns 100..111 of every row, then rows 100..111, 4 at a time
  constexpr int RIGHT = MP * (MP - HR) / 4, BOTTOM = (MP - HR) * HR / 4;
  for (int q = tid; q < RIGHT + BOTTOM; q += THREADS) {
    const int k = q < RIGHT ? q / 3 : HR + (q - RIGHT) / (HR / 4);
    const int j = q < RIGHT ? HR + 4 * (q % 3) : 4 * ((q - RIGHT) % (HR / 4));
    *reinterpret_cast<uint2*>(Dm + k * LDB + j) = make_uint2(0u, 0u);
    if constexpr (PLANES == 2) *reinterpret_cast<uint2*>(Dm + BMAT + k * LDB + j) = make_uint2(0u, 0u);
  }
}

// The n depth tiles of a product; built with -DTPSF_PROBE_NO_BAND none, as
// band_steps: the results are wrong, and the time is that of everything
// else in the kernel.
__device__ __forceinline__ int product_steps(int n) {
#ifdef TPSF_PROBE_NO_BAND
  return 0 * n;
#else
  return n;
#endif
}

// The contact bits of the pixels (i, j0 + 8 nt + e), nt = 0..12, e = 0, 1,
// as bit 2 nt + e, from mask_and_d's ballot-order words (i < 100, j0 even and
// < 8).  Pixel p is quad q = p / 4, component c = p % 4; j0 even makes c = 0
// or 2 for every nt, and quad q0 + 2 nt.  So the bits of e = 0 are every
// other bit of words 4 (q0 / 32) + c and 4 (q0 / 32 + 1) + c from bit q0 % 32
// on, and those of e = 1 the same of words + 1: two 8-byte loads.
__device__ __forceinline__ unsigned row_contact_bits(const unsigned* mask, int i, int j0) {
  const int p0 = i * HR + j0, q0 = p0 >> 2, c = p0 & 3;
  const uint2 lo = *reinterpret_cast<const uint2*>(mask + 4 * (q0 >> 5) + c);
  const uint2 hi = *reinterpret_cast<const uint2*>(mask + 4 * ((q0 >> 5) + 1) + c);
  const int sh = q0 & 31;  // sh + 24 < 64
  const uint64_t e0 = ((uint64_t)hi.x << 32 | lo.x) >> sh, e1 = ((uint64_t)hi.y << 32 | lo.y) >> sh;
  constexpr uint64_t EVEN = 0x1555555u;  // bits 0, 2, ..., 24: one per n-tile
  return (unsigned)(e0 & EVEN) | (unsigned)(e1 & EVEN) << 1;
}

// Product 1 of warp mt's stripe: acc[nt] = the 16x8 tile (mt, nt) of
// T = A . D over the band's depth tiles kt, A from tile kt - mt, D through
// ldmatrix.trans from D[k][n]; with two planes A's lo tiles and D's lo
// plane beside the hi ones.  Only the NTM n-tiles that hold map columns:
// T's columns 104..111 are zero (D's are).
template <int PLANES>
__device__ __forceinline__ void stripe_t(const __nv_bfloat16* tiles, const __nv_bfloat16* Dm,
                                         int mt, float acc[NTM][4]) {
  const int lane = threadIdx.x & 31;
  const int xrow = lane & 15, xcol = (lane >> 4) * 8;
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int kt0 = max(0, mt - BAND_TILES), kt1 = min(MT - 1, mt + BAND_TILES);
#pragma unroll 1
  for (int kt = kt0; kt < kt0 + product_steps(kt1 - kt0 + 1); ++kt) {
    uint32_t a[4], al[4] = {};  // al (and hl in the epilogue) only with two planes
    ldsm_x4<false>(a, a_tile(tiles, kt - mt) + xrow * LDT + xcol);
    if constexpr (PLANES == 2) ldsm_x4<false>(al, a_tile(tiles + NOFFS * TILE, kt - mt) + xrow * LDT + xcol);
    if constexpr (PLANES == 1) {
#pragma unroll
      for (int np = 0; np < MT; ++np) {
        uint32_t bb[4];
        ldsm_x4<true>(bb, Dm + (kt * 16 + xrow) * LDB + np * 16 + xcol);
        mma_bf16(acc[2 * np], a, bb[0], bb[1]);
        if (2 * np + 1 < NTM) mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    } else {  // one n-tile at a time: hi and lo B fragments in 4 registers
#pragma unroll
      for (int nt = 0; nt < NTM; ++nt) {
        uint32_t bh[2], bl[2];
        ldsm_x2<true>(bh, Dm + (kt * 16 + xrow) * LDB + nt * 8);
        ldsm_x2<true>(bl, Dm + BMAT + (kt * 16 + xrow) * LDB + nt * 8);
        mma_step<PLANES>(acc[nt], a, al, bh[0], bh[1], bl[0], bl[1]);
      }
    }
  }
}

// Product 2 of warp mt's stripe: acc[nt] = the tile (mt, nt) of
// HR0 / alpha = T . A^T, T's rows as stored, A^T's 16x16 block (kt, np) =
// A's block (np, kt) = tile kt - np read as stored (n x k), only where
// |kt - np| <= 4; with two planes T's lo plane and A's lo tiles beside the
// hi ones.  The NTM n-tiles that hold map columns.
template <int PLANES>
__device__ __forceinline__ void stripe_hr0(const __nv_bfloat16* Tm, const __nv_bfloat16* tiles,
                                           int mt, float acc[NTM][4]) {
  const int lane = threadIdx.x & 31;
  const int xrow = lane & 15, xcol = (lane >> 4) * 8;
  const int yrow = (lane & 7) + ((lane >> 4) << 3), ycol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 1
  for (int kt = 0; kt < product_steps(MT); ++kt) {
    uint32_t a[4], al[4] = {};
    ldsm_x4<false>(a, Tm + (mt * 16 + xrow) * LDB + kt * 16 + xcol);
    if constexpr (PLANES == 2) ldsm_x4<false>(al, Tm + BMAT + (mt * 16 + xrow) * LDB + kt * 16 + xcol);
#pragma unroll
    for (int np = 0; np < MT; ++np) {
      if (np - kt > BAND_TILES || kt - np > BAND_TILES) continue;
      if constexpr (PLANES == 1) {
        uint32_t bb[4];
        ldsm_x4<false>(bb, a_tile(tiles, kt - np) + yrow * LDT + ycol);
        mma_bf16(acc[2 * np], a, bb[0], bb[1]);
        if (2 * np + 1 < NTM) mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
      } else {  // one n-tile at a time: hi and lo B fragments in 4 registers
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (2 * np + h >= NTM) continue;
          uint32_t bh[2], bl[2];
          const int at = (8 * h + (lane & 7)) * LDT + ((lane >> 3) & 1) * 8;
          ldsm_x2<false>(bh, a_tile(tiles, kt - np) + at);
          ldsm_x2<false>(bl, a_tile(tiles + NOFFS * TILE, kt - np) + at);
          mma_step<PLANES>(acc[2 * np + h], a, al, bh[0], bh[1], bl[0], bl[1]);
        }
      }
    }
  }
}

// Block-wide (max, sum, count) in one round; every thread gets the result.
// Starts with a barrier, as block_reduce.
__device__ __forceinline__ void block_reduce3(float& mx, float& sum, float& cnt, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  mx = warp_max(mx);
  sum = warp_sum(sum);
  cnt = warp_sum(cnt);
  __syncthreads();
  if (lane == 0) {
    red[warp] = mx;
    red[RED3 + warp] = sum;
    red[2 * RED3 + warp] = cnt;
  }
  __syncthreads();
  mx = red[0];
  sum = red[RED3];
  cnt = red[2 * RED3];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    mx = fmaxf(mx, red[w]);
    sum += red[RED3 + w];
    cnt += red[2 * RED3 + w];
  }
}

template <int PLANES>
__device__ __forceinline__ void tpsf_physics_bf16_tiled(
    const float* __restrict__ depth, const float* __restrict__ abm, float* __restrict__ hr_out,
    float* __restrict__ lr_out, float c_psf, float c_mask, float disturbance, float degrade_scale) {
  using L = TiledSmem<PLANES>;
  extern __shared__ __align__(16) unsigned char smem_b[];
  float* r0 = reinterpret_cast<float*>(smem_b + L::R0);
  __nv_bfloat16* Dm = reinterpret_cast<__nv_bfloat16*>(smem_b + L::R0);  // then T
  float* Vp = reinterpret_cast<float*>(smem_b + L::R0);                  // at last V's partials
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_b + L::TILES);
  float* gpad = reinterpret_cast<float*>(smem_b + L::G);
  float* Uh = reinterpret_cast<float*>(smem_b + L::U);
  [[maybe_unused]] float* Ul = Uh + TAXELS * HR;  // U's lo plane, with two planes
  unsigned* mask = reinterpret_cast<unsigned*>(smem_b + L::MASK);
  float* red = reinterpret_cast<float*>(smem_b + L::RED);
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem_b + L::MBAR);

  [[maybe_unused]] constexpr int PROBE_LAST = 6;
  PROBE_INIT();
  PROBE(0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const size_t b = blockIdx.x;
  const float alpha = abm[3 * b + 0];
  const float beta = abm[3 * b + 1];
  const float m = abm[3 * b + 2];

  // 1. depth -> r0 by one bulk copy, overlapped with gpad, U's planes (both
  //    of its uses are products) and A's tiles in bf16
  if (tid == 0) mbar_init(mbar);
  __syncthreads();
  if (tid == 0) bulk_load(r0, depth + b * NPIX, mbar);
  psf_and_mask_taps(gpad, Uh, beta, m, c_psf, c_mask);
  for (int q = tid; q < TAXELS * HR; q += THREADS) {  // its own entries
    if constexpr (PLANES == 2) Ul[q] = bf16_round(Uh[q] - bf16_round(Uh[q]));
    Uh[q] = bf16_round(Uh[q]);
  }
  __syncthreads();  // gpad published
  for (int p = tid; p < NOFFS * 16 * 8; p += THREADS) {  // pairs: 9 tiles x 16 rows x 8
    const int t = p >> 7, r = (p >> 3) & 15, c = 2 * (p & 7);
    const int o = 16 * (t - BAND_TILES) + c - r;  // k - i, in -79..79
    *reinterpret_cast<uint32_t*>(tiles + t * TILE + r * LDT + c) =
        pack_bf16(gpad[GPAD_C + o], gpad[GPAD_C + o + 1]);
    if constexpr (PLANES == 2)
      *reinterpret_cast<uint32_t*>(tiles + (NOFFS + t) * TILE + r * LDT + c) =
          pack_bf16_lo(gpad[GPAD_C + o], gpad[GPAD_C + o + 1]);
  }
  mbar_wait(mbar, 0);
  __syncthreads();  // the map has landed; the tiles and U are published
  PROBE(1);

  // 2. the max and the mask bits from the f32 map; D's planes over it
  mask_and_d<PLANES>(r0, red, disturbance, mask, Dm);
  __syncthreads();  // D and the mask published
  PROBE(2);

  // 3. T = A . D in registers; once every warp has read D, T's planes over
  //    it (hi, and lo = bf16(T - hi): T is an f32 sum split only as product
  //    2's operand)
  float acc[NTM][4];
  if (warp < MT) stripe_t<PLANES>(tiles, Dm, warp, acc);
  __syncthreads();  // every read of D is done
  __nv_bfloat16* Tm = Dm;
  if (warp < MT) {
    uint32_t* w = reinterpret_cast<uint32_t*>(Tm + (warp * 16 + g) * LDB) + tg;
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt) {
      w[nt * 4] = pack_bf16(acc[nt][0], acc[nt][1]);
      w[nt * 4 + 4 * LDB] = pack_bf16(acc[nt][2], acc[nt][3]);  // row + 8
      if constexpr (PLANES == 2) {
        w[BMAT / 2 + nt * 4] = pack_bf16_lo(acc[nt][0], acc[nt][1]);
        w[BMAT / 2 + nt * 4 + 4 * LDB] = pack_bf16_lo(acc[nt][2], acc[nt][3]);
      }
    }
    w[NTM * 4] = w[NTM * 4 + 4 * LDB] = 0u;  // columns 104..111, zero as D's
    if constexpr (PLANES == 2) w[BMAT / 2 + NTM * 4] = w[BMAT / 2 + NTM * 4 + 4 * LDB] = 0u;
  }
  __syncthreads();  // T published
  PROBE(3);

  // 4. HR0 = alpha T . A^T in registers.  Each thread's places are rows
  //    i_h = 16 warp + g + 8h and columns j = 8 nt + 2 tg + e (acc[nt][2h + e]);
  //    bit 2 nt + e of cbits[h] says (i_h, j) is a contact pixel.
  //    Non-contact pixels give the second max (the contact pixels' zeros are
  //    its floor: a map has a contact pixel, the max) and sum(HR) without the
  //    contact pixels; with their count, sum(HR) = that sum + count * second.
  //    One reduction for all three.  acc keeps alpha HR0 at the non-contact
  //    pixels and zero elsewhere (the padding included).
  const bool row_in[2] = {warp * 16 + g < HR, warp * 16 + g + 8 < HR};
  unsigned cbits[2] = {0u, 0u};
  float second = 0.f, nsum = 0.f, count = 0.f;
  if (warp < MT) {
    stripe_hr0<PLANES>(Tm, tiles, warp, acc);
#pragma unroll
    for (int h = 0; h < 2; ++h)  // j = 8 nt + 2 tg < 100: n-tile 12 only for tg < 2
      if (row_in[h])
        cbits[h] = row_contact_bits(mask, warp * 16 + g + 8 * h, 2 * tg) & (tg < 2 ? 0x3ffffffu : 0xffffffu);
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool in = row_in[h] && (nt < NTM - 1 || tg < 2);
        const float v = alpha * acc[nt][e];
        const bool open = in && !(cbits[h] >> (2 * nt + (e & 1)) & 1u);
        if (open) {
          second = fmaxf(second, v);
          nsum += v;
        }
        acc[nt][e] = open ? v : 0.f;
      }
    count = (float)(__popc(cbits[0]) + __popc(cbits[1]));
  }
  block_reduce3(second, nsum, count, red);  // its first barrier: every read of T is done
  const float hsum = nsum + count * second;
  PROBE(4);

  // 5. HR = contact ? second : HR0, stored from registers (a quad of lanes
  //    writes 32 contiguous bytes of a row), and zero outside the map; then
  //    V = U . HR on the tensor cores, HR split into PLANES planes: per
  //    8-column n-tile, B = the stripe's 16 x 8 HR (the C fragment
  //    transposed by movmatrix is the B fragment), A = U's four rows over
  //    the stripe's 16 rows.  Each warp stores its stripe's partial; LR sums
  //    them in a fixed order.
  if (warp < MT) {
    float* out = hr_out + b * NPIX;
    uint32_t ua[4] = {0u, 0u, 0u, 0u}, ul[4] = {0u, 0u, 0u, 0u};
    if (g < TAXELS) {
      const int i0 = warp * 16 + 2 * tg;
      const float* u = Uh + g * HR;
      ua[0] = pack_bf16(i0 < HR ? u[i0] : 0.f, i0 + 1 < HR ? u[i0 + 1] : 0.f);
      ua[2] = pack_bf16(i0 + 8 < HR ? u[i0 + 8] : 0.f, i0 + 9 < HR ? u[i0 + 9] : 0.f);
      if constexpr (PLANES == 2) {
        const float* v = Ul + g * HR;
        ul[0] = pack_bf16(i0 < HR ? v[i0] : 0.f, i0 + 1 < HR ? v[i0 + 1] : 0.f);
        ul[2] = pack_bf16(i0 + 8 < HR ? v[i0 + 8] : 0.f, i0 + 9 < HR ? v[i0 + 9] : 0.f);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt) {
      uint32_t hb[2], hl[2] = {0u, 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned bits = cbits[h] >> (2 * nt);
        const float v0 = bits & 1u ? second : acc[nt][2 * h];
        const float v1 = bits & 2u ? second : acc[nt][2 * h + 1];
        if (row_in[h] && (nt < NTM - 1 || tg < 2))
          *reinterpret_cast<float2*>(out + (warp * 16 + g + 8 * h) * HR + nt * 8 + 2 * tg) =
              make_float2(v0, v1);
        hb[h] = movmatrix_trans(pack_bf16(v0, v1));
        if constexpr (PLANES == 2) hl[h] = movmatrix_trans(pack_bf16_lo(v0, v1));
      }
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_step<PLANES>(c, ua, ul, hb[0], hb[1], hl[0], hl[1]);
      if (g < TAXELS)
        *reinterpret_cast<float2*>(Vp + (warp * TAXELS + g) * VLD + nt * 8 + 2 * tg) = make_float2(c[0], c[1]);
    }
  }
  __syncthreads();  // V's partials published
  PROBE(5);

  // 6. LR = (V . U^T at the kernel's precision - mn * sum(HR)) / (1 - mn)
  //    * scale, V the sum of the stripes' partials in stripe order: warp w
  //    gives outputs (a, c) and (a, c + 1), a = w / 2, c = 2 (w % 2), from
  //    one sum of V's row a
  const float mn = expf(-100.0f / m);
  const int a = warp >> 1, c = 2 * (warp & 1);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int x = lane; x < HR; x += 32) {
    float v = Vp[a * VLD + x];
#pragma unroll
    for (int w = 1; w < MT; ++w) v += Vp[(w * TAXELS + a) * VLD + x];
    const float vh = bf16_round(v);
    s0 = fmaf(vh, Uh[c * HR + x], s0);
    if constexpr (PLANES == 2) {
      s0 = fmaf(vh, Ul[c * HR + x], s0);
      s0 = fmaf(bf16_round(v - vh), Uh[c * HR + x], s0);
    }
    s1 = fmaf(vh, Uh[(c + 1) * HR + x], s1);
    if constexpr (PLANES == 2) {
      s1 = fmaf(vh, Ul[(c + 1) * HR + x], s1);
      s1 = fmaf(bf16_round(v - vh), Uh[(c + 1) * HR + x], s1);
    }
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  if (lane == 0) {
    float* lr = lr_out + b * TAXELS * TAXELS + a * TAXELS + c;
    lr[0] = (s0 - mn * hsum) / (1.0f - mn) * degrade_scale;
    lr[1] = (s1 - mn * hsum) / (1.0f - mn) * degrade_scale;
  }
  PROBE(PROBE_LAST);
}

// Three blocks per SM: 80 registers a thread, which ptxas meets without
// spilling (the build phase of chip_smoke.py and the GPU tests check it).
__global__ void __launch_bounds__(THREADS, 3)
tpsf_physics_bf16_kernel(const float* __restrict__ depth, const float* __restrict__ abm,
                         float* __restrict__ hr_out, float* __restrict__ lr_out,
                         float c_psf, float c_mask, float disturbance, float degrade_scale) {
  tpsf_physics_bf16_tiled<1>(depth, abm, hr_out, lr_out, c_psf, c_mask, disturbance, degrade_scale);
}

// Three blocks per SM too: 80 registers a thread (the same checks).
__global__ void __launch_bounds__(THREADS, 3)
tpsf_physics_bf16x3_kernel(const float* __restrict__ depth, const float* __restrict__ abm,
                           float* __restrict__ hr_out, float* __restrict__ lr_out,
                           float c_psf, float c_mask, float disturbance, float degrade_scale) {
  tpsf_physics_bf16_tiled<2>(depth, abm, hr_out, lr_out, c_psf, c_mask, disturbance, degrade_scale);
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

// The bf16 forward over B samples on `stream`: `passes` 1 (precision
// DEFAULT, tpsf_physics_bf16_kernel) or 3 (HIGH, tpsf_physics_bf16x3_kernel);
// the arguments as tpsf_physics_launch's.  Returns the cudaError_t.
extern "C" int tpsf_physics_bf16_launch(const float* depth, const float* abm, float* hr,
                                        float* lr, int batch, int passes, float c_psf,
                                        float c_mask, float disturbance, float degrade_scale,
                                        void* stream) {
  if (passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  const auto kernel = passes == 1 ? tpsf_physics_bf16_kernel : tpsf_physics_bf16x3_kernel;
  const size_t smem = passes == 1 ? BF16_SMEM_BYTES : BF16X3_SMEM_BYTES;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, THREADS, smem, (cudaStream_t)stream>>>(depth, abm, hr, lr, c_psf, c_mask,
                                                         disturbance, degrade_scale);
  return (int)cudaGetLastError();
}

// Occupancy and resources of kernel `which` (0 = forward, 1 = backward,
// 2 = bf16 forward, 3 = its three-pass form) on
// the current device: out[0..5] = resident blocks per SM, threads per block,
// dynamic and static shared bytes, registers per thread, local (spill)
// bytes per thread.  Returns the cudaError_t.
extern "C" int tpsf_kernel_info(int which, int* out) {
  if (which == 0) return kernel_info(tpsf_physics_kernel, SMEM_BYTES, out);
  if (which == 1) return kernel_info(tpsf_physics_bwd_kernel, B_SMEM_BYTES, out);
  if (which == 2) return kernel_info(tpsf_physics_bf16_kernel, BF16_SMEM_BYTES, out);
  if (which == 3) return kernel_info(tpsf_physics_bf16x3_kernel, BF16X3_SMEM_BYTES, out);
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
