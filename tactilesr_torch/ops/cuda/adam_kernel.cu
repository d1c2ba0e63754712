// AdamL2 for Hopper (sm_90a): one launch updates every parameter tensor of
// a param group, the optimizer step of the captured training step.
//
// It replaces no TPU kernel: the JAX package leaves its optimizer
// (tactilesr_tpu/runtime/optim.py::adam_l2, optax's add_decayed_weights ->
// scale_by_adam) to XLA, which fuses it into the jitted step.  In PyTorch
// the same update is torch's capturable foreach Adam: ~260 small launches
// a step for 124 tensors, with an f32 sqrt and divides whose IEEE slow path
// runs for every denormal exp_avg_sq.  This kernel computes torch's
// capturable Adam with coupled L2, in its order, per element in f32:
//
//   g'  = g + wd p                       (only where wd != 0)
//   m   = lerp(m, g', 1 - b1)            = m + (1 - b1) (g' - m)
//   v   = b2 v;  v = v + (1 - b2) g'^2
//   t   = step + 1;  step = t
//   step_size = 1 / ((b1^t - 1) / lr)    (< 0)
//   d   = sqrt(v) / sqrt(1 - b2^t);  d = d + eps;  d = d / step_size
//   p   = p + m / d
//
// Its plain PyTorch version is ops/cuda/adam.py::adam_l2_plain.
//
// What bounds it on an H100: bytes.  It reads p, g, m, v and writes p, m,
// v: 28 B a parameter, 128 MB for the 4.58M parameters of the STSR, ~38 us
// at 3.35 TB/s, against a few hundred FLOP a parameter.  So the design is
// a streaming pass:
//   - one grid over the work list: chunk c of the grid is chunk
//     c - start[i] of tensor i, where start[] holds the prefix sums of the
//     tensors' chunk counts (ADAM_CHUNK elements a chunk), so every element
//     of every tensor is covered exactly once; a block finds its tensor by
//     a binary search over start[] (uniform in the block: constant-bank
//     reads);
//   - the work list and the tensors' pointers and sizes travel by value,
//     as a __grid_constant__ kernel parameter (CUDA 12.1+ takes 32,764
//     bytes of them on sm_90): a graph capture records them with the
//     launch, and no table in device memory has to outlive the capture.
//     The struct holds up to 512 tensors in 26.7 KB (the recipes have 8
//     to 160); the wrapper raises on a longer list;
//   - 16-byte loads and stores of p, g, m and v where all four base
//     pointers are 16-byte aligned (every chunk then is: a chunk starts at
//     a multiple of ADAM_CHUNK elements), all loads of a thread issued
//     before its arithmetic; a scalar tail for the last n % 4 elements, and
//     a scalar chunk where a pointer is not aligned;
//   - the learning rate and each tensor's step count are read from device
//     memory, so the launch is capturable; the bias corrections are
//     computed once per block, by its first thread, from its tensor's
//     step.  The step counters advance in the same launch: the last block
//     to finish (a ticket counter, reset by that block) adds 1 to each,
//     after every block has read them;
//   - time independent of the data: the f32 sqrt and divide take an IEEE
//     slow path for zero or denormal operands, which exp_avg_sq and
//     exp_avg become as gradients vanish.  sqrt(v) and m / d run in f64
//     (every f32, denormals included, is a normal f64, so the f64 fast path
//     always runs) and are rounded once to f32: as 53 >= 2 * 24 + 2, that
//     second rounding gives the correctly rounded f32 result, bit for bit
//     the IEEE sqrt.rn / div.rn, denormal results included.  Zero operands
//     are selected around, not branched on.  sqrt(v) / bc2 goes the same
//     way (its numerator may be zero); the divide by step_size has
//     operands bounded away from zero (d >= eps) and stays f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ADAM_THREADS = 256;
constexpr int ADAM_VEC = 2;  // float4 groups a thread takes in a chunk
constexpr int ADAM_CHUNK = ADAM_THREADS * 4 * ADAM_VEC;  // 2048 elements

struct AdamTensor {
  float* p;
  const float* g;
  float* m;
  float* v;
  float* step;
  long long n;
};

constexpr int ADAM_MAX_TENSORS = 512;

struct AdamArgs {
  const float* lr;
  unsigned int* ticket;
  float b1, b1c, b2, b2c, eps, wd;  // b1c = 1 - b1, b2c = 1 - b2, as f32
  int n_tensors, n_chunks;
  int start[ADAM_MAX_TENSORS + 1];  // start[i]: tensor i's first chunk; start[n_tensors] = n_chunks
  AdamTensor t[ADAM_MAX_TENSORS];
};

static_assert(sizeof(AdamArgs) <= 32764, "kernel parameters are limited to 32,764 bytes");

// IEEE sqrt.rn of x >= 0 through f64 (see the header): no slow path.
__device__ __forceinline__ float sqrt_rn(float x) {
  const float r = (float)sqrt(x == 0.f ? 1.0 : (double)x);
  return x == 0.f ? x : r;
}

// IEEE div.rn of a by b (b finite, nonzero) through f64: no slow path for a
// zero or denormal a.
__device__ __forceinline__ float div_rn(float a, float b) {
  const float q = (float)((a == 0.f ? 1.0 : (double)a) / (double)b);
  return a == 0.f ? __int_as_float((__float_as_int(a) ^ __float_as_int(b)) & 0x80000000) : q;
}

struct Coef {
  float b1c, b2, b2c, eps, wd, step_size, bc2;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v, const Coef& c) {
  if (c.wd != 0.f) g = g + c.wd * p;
  m = m + c.b1c * (g - m);
  v = v * c.b2;
  v = v + c.b2c * (g * g);
  float d = div_rn(sqrt_rn(v), c.bc2);
  d = d + c.eps;
  d = d / c.step_size;
  p = p + div_rn(m, d);
}

__device__ __forceinline__ void adam_four(float4& p, const float4& g, float4& m, float4& v,
                                          const Coef& c) {
  adam_one(p.x, g.x, m.x, v.x, c);
  adam_one(p.y, g.y, m.y, v.y, c);
  adam_one(p.z, g.z, m.z, v.z, c);
  adam_one(p.w, g.w, m.w, v.w, c);
}

__global__ void __launch_bounds__(ADAM_THREADS) adam_l2_kernel(const __grid_constant__ AdamArgs a) {
  __shared__ int s_tensor;
  __shared__ float s_step_size, s_bc2;
  __shared__ unsigned int s_ticket;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    int lo = 0, hi = a.n_tensors;  // the last i with start[i] <= c (skips empty tensors)
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (a.start[mid] <= c) lo = mid; else hi = mid;
    }
    s_tensor = lo;
    if (c < a.n_chunks) {
      const float t = *a.t[lo].step + 1.0f;
      const float lr = *a.lr;
      s_step_size = 1.0f / ((powf(a.b1, t) - 1.0f) / lr);
      s_bc2 = sqrtf(-(powf(a.b2, t) - 1.0f));
    }
  }
  __syncthreads();

  if (c < a.n_chunks) {
    const AdamTensor& T = a.t[s_tensor];
    const Coef k{a.b1c, a.b2, a.b2c, a.eps, a.wd, s_step_size, s_bc2};
    const long long base = (long long)(c - a.start[s_tensor]) * ADAM_CHUNK;
    const int len = (int)(T.n - base < ADAM_CHUNK ? T.n - base : ADAM_CHUNK);
    float* p = T.p + base;
    const float* g = T.g + base;
    float* m = T.m + base;
    float* v = T.v + base;
    const bool aligned = ((reinterpret_cast<uintptr_t>(T.p) | reinterpret_cast<uintptr_t>(T.g) |
                           reinterpret_cast<uintptr_t>(T.m) | reinterpret_cast<uintptr_t>(T.v)) &
                          15) == 0;
    int done = 0;  // elements the vector path took
    if (aligned) {
      const int nvec = len >> 2;
      float4 P[ADAM_VEC], G[ADAM_VEC], M[ADAM_VEC], V[ADAM_VEC];
#pragma unroll
      for (int k2 = 0; k2 < ADAM_VEC; ++k2) {
        const int j = tid + k2 * ADAM_THREADS;
        if (j < nvec) {
          P[k2] = reinterpret_cast<const float4*>(p)[j];
          G[k2] = __ldg(reinterpret_cast<const float4*>(g) + j);
          M[k2] = reinterpret_cast<const float4*>(m)[j];
          V[k2] = reinterpret_cast<const float4*>(v)[j];
        }
      }
#pragma unroll
      for (int k2 = 0; k2 < ADAM_VEC; ++k2) {
        const int j = tid + k2 * ADAM_THREADS;
        if (j < nvec) {
          adam_four(P[k2], G[k2], M[k2], V[k2], k);
          reinterpret_cast<float4*>(p)[j] = P[k2];
          reinterpret_cast<float4*>(m)[j] = M[k2];
          reinterpret_cast<float4*>(v)[j] = V[k2];
        }
      }
      done = nvec << 2;
    }
    for (int e = done + tid; e < len; e += ADAM_THREADS) {
      float pe = p[e], me = m[e], ve = v[e];
      adam_one(pe, g[e], me, ve, k);
      p[e] = pe;
      m[e] = me;
      v[e] = ve;
    }
  }

  // the last block to finish advances every tensor's step: each block read
  // its step (thread 0, above) before it took its ticket
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_ticket = atomicAdd(a.ticket, 1u);
  }
  __syncthreads();
  if (s_ticket == gridDim.x - 1) {
    for (int i = tid; i < a.n_tensors; i += ADAM_THREADS) *a.t[i].step += 1.0f;
    if (tid == 0) *a.ticket = 0u;
  }
}

}  // namespace

// One AdamL2 step of n <= 512 tensors on `stream`; returns the cudaError_t.
// ptrs: n x 5 device pointers (p, g, exp_avg, exp_avg_sq, step), f32, each
// of p, g, m, v dense with one shared layout (the kernel walks their
// storage); numels: n sizes; starts: n + 1 prefix sums of the tensors'
// chunk counts (ceil(numel / 2048)); lr: a device f32 scalar; ticket: a
// device u32 that is 0 (the kernel leaves it 0).  b1c = 1 - b1 and
// b2c = 1 - b2 as the host rounds them.
extern "C" int adam_l2_launch(const long long* ptrs, const long long* numels, const int* starts,
                              int n, const float* lr, unsigned int* ticket, float b1, float b1c,
                              float b2, float b2c, float eps, float wd, void* stream) {
  if (n <= 0 || n > ADAM_MAX_TENSORS) return (int)cudaErrorInvalidValue;
  AdamArgs a;
  a.lr = lr;
  a.ticket = ticket;
  a.b1 = b1;
  a.b1c = b1c;
  a.b2 = b2;
  a.b2c = b2c;
  a.eps = eps;
  a.wd = wd;
  a.n_tensors = n;
  a.n_chunks = starts[n];
  for (int i = 0; i <= n; ++i) a.start[i] = starts[i];
  for (int i = 0; i < n; ++i) {
    a.t[i].p = reinterpret_cast<float*>(ptrs[5 * i]);
    a.t[i].g = reinterpret_cast<const float*>(ptrs[5 * i + 1]);
    a.t[i].m = reinterpret_cast<float*>(ptrs[5 * i + 2]);
    a.t[i].v = reinterpret_cast<float*>(ptrs[5 * i + 3]);
    a.t[i].step = reinterpret_cast<float*>(ptrs[5 * i + 4]);
    a.t[i].n = numels[i];
  }
  const int grid = a.n_chunks > 0 ? a.n_chunks : 1;  // one block still advances the steps
  adam_l2_kernel<<<grid, ADAM_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The tensors one launch takes at most, and the elements of a chunk.
extern "C" int adam_l2_limits(int* out) {
  out[0] = ADAM_MAX_TENSORS;
  out[1] = ADAM_CHUNK;
  return 0;
}

// Occupancy and resources of the kernel (`which` 0, its only one) on the
// current device, as tpsf_kernel_info gives them.  Returns the cudaError_t.
extern "C" int adam_kernel_info(int which, int* out) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, adam_l2_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, adam_l2_kernel, ADAM_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = ADAM_THREADS;
  out[2] = 0;
  out[3] = (int)attr.sharedSizeBytes;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return (int)cudaSuccess;
}

extern "C" const char* adam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
