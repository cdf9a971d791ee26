// Fused CG iterations for Hopper (sm_90a): the two-pass iteration (kernels A
// and B) and the one-pass Chronopoulos-Gear iteration (kernel CGCG).
//
// Replaces sparse_tpu/kernels/cg_dia.py::_kernel_a (pallas_call at :501)
// and ::_kernel_b (pallas_call at :536), driven by cg_dia_fused, and
// ::_kernel_cgcg (pallas_call at :374), driven by cg_dia_fused_onepass.
//
// Layout: every vector is padded to [m_pad + 2B], the m_pad rows at offset
// B and zeros in both halos (the kernels never write a halo). The matrix is
// the row-indexed [D * m_pad] plane buffer of dia_pack, at the vector type
// or, for f32 vectors, in bf16 (widened to f32 at the load; the multiply and
// add stay in f32). The CG scalars live on the device in sc[4]; the host
// reads rho once per chunk of iterations and never inside one.
//
// Kernel A: beta = rho_prev == 0 ? 0 : rho / rho_prev; p_new = r + beta * p;
//   q = A p_new; the dot <p_new, q>. Like the TPU kernel it recomputes
//   r + beta * p at the neighbour rows i + o_k it needs rather than wait for
//   another block to publish p_new, so there is no grid-wide barrier. p_new
//   goes to a second buffer (ping-pong with p): other blocks still read the
//   old p during the launch.
// Kernel B: x += alpha * p; r -= alpha * q; the dot <r, r>. Each row is read
//   and written by one thread only, so x and r are updated in place.
//   Two-pass scalars: sc = {rho_prev, rho, pq, alpha}.
// Kernel CGCG: one launch per iteration. From sc = {rho_prev, rho, mu,
//   alpha_prev} every thread forms beta = rho_prev == 0 ? 0 : rho / rho_prev,
//   ratio = alpha_prev == 0 ? 0 : beta / alpha_prev, and alpha = rho /
//   (mu - ratio * rho), 0 where that denominator is 0 (the reference's
//   guards). Then per row: s' = w + beta * s and r' = r - alpha * s' at the
//   row and at each neighbour it reads (recomputed, as in kernel A);
//   w' = A r'; p = r + beta * p; x += alpha * p; the dots <r', r'> and
//   <w', r'>. On the TPU the tiles run in order, so a tile may read its
//   neighbours' old r, w and s from the buffer it writes; here blocks run at
//   once, so r, w and s each ping-pong between two buffers. p and x are
//   read and written at the thread's own row only and are updated in place.
//   The last block sets rho_prev = rho, rho = <r', r'>, mu = <w', r'> and
//   alpha_prev = alpha == 0 ? 1 : alpha.
//
// Dots without float atomics: each block writes its partials; the last block
// to finish (an integer ticket) sums them in a fixed order and updates the
// scalars. The grid size depends only on m_pad, so a repeated solve gives
// bit-identical iterates.
//
// What bounds them: memory. Per row and iteration kernel A streams r and p
// (the D shifted reads hit L1/L2), D planes, and writes p_new and q; kernel
// B reads x, p, r, q and writes x and r: (2 + D + 2 + 4 + 2) values, 60 bytes
// per row at D = 5 in f32, about 2.16 GB per iteration at 6000^2. Kernel
// CGCG reads r, w, s, p, x and D planes and writes r', w', s', p, x: the
// same 15 values a row in one launch and one grid-wide reduction instead of
// two; bf16 planes take 10 of its 60 bytes off.
//
// Design: grid-stride loops with a fixed grid of at most 1024 blocks of 256
// threads (enough resident warps to keep HBM busy on 132 SMs), coalesced
// streams, the shifted reads through the read-only cache. A staged
// shared-memory halo window is left for later: at 6000^2 the band is 6000
// rows, so a 1024-row tile would stage ~13x its own rows. Elementwise
// results and the scalar recurrence use explicitly rounded operations, so
// the vectors equal the plain torch versions bit for bit given the same
// scalars.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Sum over the block in a fixed order; the result is valid in thread 0.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : T(0);
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // warp_sums may be reused by the next call
  return v;
}

// Every block adds its N values v[] to partials ([N][gridDim.x]); the block
// that finishes last returns true with the fixed-order grid totals in v[]
// (thread 0) and rearms the ticket for the next launch.
template <int N, typename T>
__device__ bool grid_sums_last(T (&v)[N], T* partials, unsigned int* ticket) {
  __shared__ bool is_last;
  for (int q = 0; q < N; ++q) v[q] = block_sum(v[q]);
  if (threadIdx.x == 0) {
    for (int q = 0; q < N; ++q) partials[q * gridDim.x + blockIdx.x] = v[q];
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  for (int q = 0; q < N; ++q) {
    T t = T(0);
    for (unsigned int b = threadIdx.x; b < gridDim.x; b += kThreads) {
      t += __ldcg(partials + q * gridDim.x + b);
    }
    v[q] = block_sum(t);
  }
  if (threadIdx.x == 0) *ticket = 0u;
  return true;
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cg_kernel_a(const P* __restrict__ planes, const T* __restrict__ r,
            const T* __restrict__ p, T* __restrict__ pnew, T* __restrict__ q,
            T* partials, unsigned int* ticket, T* sc, long long m_pad, long long B,
            StkOffsets offs, int D) {
  const T rho_prev = sc[0], rho = sc[1];
  const T beta = rho_prev == T(0) ? T(0) : rho / rho_prev;
  const long long stride = (long long)gridDim.x * kThreads;
  T dot[1] = {T(0)};
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m_pad; i += stride) {
    const long long c = B + i;
    T acc = T(0);
    for (int k = 0; k < D; ++k) {
      const long long j = c + offs.o[k];
      const T pw = add_rn(__ldg(r + j), mul_rn(beta, __ldg(p + j)));
      acc = add_rn(acc, mul_rn(widen(planes[(long long)k * m_pad + i]), pw));
    }
    const T mid = add_rn(__ldg(r + c), mul_rn(beta, __ldg(p + c)));
    pnew[c] = mid;
    q[c] = acc;
    dot[0] += mid * acc;
  }
  if (grid_sums_last(dot, partials, ticket) && threadIdx.x == 0) {
    const T pq = dot[0];
    sc[2] = pq;
    sc[3] = rho / (pq == T(0) ? T(1) : pq);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_kernel_b(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
            const T* __restrict__ q, T* partials, unsigned int* ticket, T* sc,
            long long m_pad, long long B) {
  const T alpha = sc[3];
  const long long stride = (long long)gridDim.x * kThreads;
  T dot[1] = {T(0)};
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m_pad; i += stride) {
    const long long c = B + i;
    x[c] = add_rn(x[c], mul_rn(alpha, p[c]));
    const T rn = sub_rn(r[c], mul_rn(alpha, q[c]));
    r[c] = rn;
    dot[0] += rn * rn;
  }
  if (grid_sums_last(dot, partials, ticket) && threadIdx.x == 0) {
    sc[0] = sc[1];
    sc[1] = dot[0];
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cgcg_kernel(const P* __restrict__ planes, const T* __restrict__ r, const T* __restrict__ w,
            const T* __restrict__ s, T* __restrict__ p, T* __restrict__ x,
            T* __restrict__ r_out, T* __restrict__ w_out, T* __restrict__ s_out,
            T* partials, unsigned int* ticket, T* sc, long long m_pad, long long B,
            StkOffsets offs, int D) {
  // every block reads sc here, before its ticket; the last block, which
  // writes sc, takes its ticket after all of them
  const T rho_prev = sc[0], rho = sc[1], mu = sc[2], alpha_prev = sc[3];
  const T beta = rho_prev == T(0) ? T(0) : rho / rho_prev;
  const T ratio = alpha_prev == T(0) ? T(0) : beta / alpha_prev;
  const T denom = sub_rn(mu, mul_rn(ratio, rho));
  const T alpha = denom == T(0) ? T(0) : rho / denom;
  const long long stride = (long long)gridDim.x * kThreads;
  T dots[2] = {T(0), T(0)};
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m_pad; i += stride) {
    const long long c = B + i;
    T acc = T(0);
    for (int k = 0; k < D; ++k) {
      const long long j = c + offs.o[k];
      const T sj = add_rn(__ldg(w + j), mul_rn(beta, __ldg(s + j)));
      const T rj = sub_rn(__ldg(r + j), mul_rn(alpha, sj));
      acc = add_rn(acc, mul_rn(widen(planes[(long long)k * m_pad + i]), rj));
    }
    const T rc = __ldg(r + c);
    const T s_mid = add_rn(__ldg(w + c), mul_rn(beta, __ldg(s + c)));
    const T r_mid = sub_rn(rc, mul_rn(alpha, s_mid));
    const T p_new = add_rn(rc, mul_rn(beta, p[c]));
    x[c] = add_rn(x[c], mul_rn(alpha, p_new));
    p[c] = p_new;
    r_out[c] = r_mid;
    s_out[c] = s_mid;
    w_out[c] = acc;
    dots[0] += r_mid * r_mid;
    dots[1] += acc * r_mid;
  }
  if (grid_sums_last(dots, partials, ticket) && threadIdx.x == 0) {
    sc[0] = rho;
    sc[1] = dots[0];
    sc[2] = dots[1];
    sc[3] = alpha == T(0) ? T(1) : alpha;
  }
}

int check_grid(long long m_pad, int nblocks) {
  if (m_pad <= 0 || nblocks < 1 || nblocks > 1024) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, typename P>
int launch_a(const P* planes, const T* r, const T* p, T* pnew, T* q, T* partials,
             unsigned int* ticket, T* sc, long long m_pad, long long B,
             const long long* offsets, int D, int nblocks, void* stream) {
  StkOffsets offs;
  int err = stk_copy_offsets(&offs, offsets, D);
  if (!err) err = check_grid(m_pad, nblocks);
  if (err) return err;
  cg_kernel_a<T, P><<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      planes, r, p, pnew, q, partials, ticket, sc, m_pad, B, offs, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_b(T* x, T* r, const T* p, const T* q, T* partials, unsigned int* ticket,
             T* sc, long long m_pad, long long B, int nblocks, void* stream) {
  int err = check_grid(m_pad, nblocks);
  if (err) return err;
  cg_kernel_b<T><<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, r, p, q, partials, ticket, sc, m_pad, B);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int launch_cgcg(const P* planes, const T* r, const T* w, const T* s, T* p, T* x, T* r_out,
                T* w_out, T* s_out, T* partials, unsigned int* ticket, T* sc, long long m_pad,
                long long B, const long long* offsets, int D, int nblocks, void* stream) {
  StkOffsets offs;
  int err = stk_copy_offsets(&offs, offsets, D);
  if (!err) err = check_grid(m_pad, nblocks);
  if (err) return err;
  cgcg_kernel<T, P><<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      planes, r, w, s, p, x, r_out, w_out, s_out, partials, ticket, sc, m_pad, B, offs, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stk_cg_kernel_a_f32(const float* planes, const float* r, const float* p, float* pnew,
                        float* q, float* partials, unsigned int* ticket, float* sc,
                        long long m_pad, long long B, const long long* offsets, int D,
                        int nblocks, void* stream) {
  return launch_a<float, float>(planes, r, p, pnew, q, partials, ticket, sc, m_pad, B,
                                offsets, D, nblocks, stream);
}

int stk_cg_kernel_a_f32_bf16(const __nv_bfloat16* planes, const float* r, const float* p,
                             float* pnew, float* q, float* partials, unsigned int* ticket,
                             float* sc, long long m_pad, long long B,
                             const long long* offsets, int D, int nblocks, void* stream) {
  return launch_a<float, __nv_bfloat16>(planes, r, p, pnew, q, partials, ticket, sc, m_pad,
                                        B, offsets, D, nblocks, stream);
}

int stk_cg_kernel_b_f32(float* x, float* r, const float* p, const float* q,
                        float* partials, unsigned int* ticket, float* sc, long long m_pad,
                        long long B, int nblocks, void* stream) {
  return launch_b<float>(x, r, p, q, partials, ticket, sc, m_pad, B, nblocks, stream);
}

int stk_cgcg_f32(const float* planes, const float* r, const float* w, const float* s,
                 float* p, float* x, float* r_out, float* w_out, float* s_out,
                 float* partials, unsigned int* ticket, float* sc, long long m_pad,
                 long long B, const long long* offsets, int D, int nblocks, void* stream) {
  return launch_cgcg<float, float>(planes, r, w, s, p, x, r_out, w_out, s_out, partials,
                                   ticket, sc, m_pad, B, offsets, D, nblocks, stream);
}

int stk_cgcg_f32_bf16(const __nv_bfloat16* planes, const float* r, const float* w,
                      const float* s, float* p, float* x, float* r_out, float* w_out,
                      float* s_out, float* partials, unsigned int* ticket, float* sc,
                      long long m_pad, long long B, const long long* offsets, int D,
                      int nblocks, void* stream) {
  return launch_cgcg<float, __nv_bfloat16>(planes, r, w, s, p, x, r_out, w_out, s_out,
                                           partials, ticket, sc, m_pad, B, offsets, D,
                                           nblocks, stream);
}

int stk_cgcg_f64(const double* planes, const double* r, const double* w, const double* s,
                 double* p, double* x, double* r_out, double* w_out, double* s_out,
                 double* partials, unsigned int* ticket, double* sc, long long m_pad,
                 long long B, const long long* offsets, int D, int nblocks, void* stream) {
  return launch_cgcg<double, double>(planes, r, w, s, p, x, r_out, w_out, s_out, partials,
                                     ticket, sc, m_pad, B, offsets, D, nblocks, stream);
}

const char* stk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
