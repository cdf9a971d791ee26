// Fused CG iteration for Hopper (sm_90a): two kernels per iteration.
//
// Replaces sparse_tpu/kernels/cg_dia.py::_kernel_a (pallas_call at :501)
// and ::_kernel_b (pallas_call at :536), driven by cg_dia_fused.
//
// Layout: every vector is padded to [m_pad + 2B], the m_pad rows at offset
// B and zeros in both halos (the kernels never write a halo). The matrix is
// the row-indexed [D * m_pad] plane buffer of dia_pack. The CG scalars live
// on the device in sc[4] = {rho_prev, rho, pq, alpha}; the host reads rho
// once per chunk of iterations and never inside one.
//
// Kernel A: beta = rho_prev == 0 ? 0 : rho / rho_prev; p_new = r + beta * p;
//   q = A p_new; the dot <p_new, q>. Like the TPU kernel it recomputes
//   r + beta * p at the neighbour rows i + o_k it needs rather than wait for
//   another block to publish p_new, so there is no grid-wide barrier. p_new
//   goes to a second buffer (ping-pong with p): other blocks still read the
//   old p during the launch.
// Kernel B: x += alpha * p; r -= alpha * q; the dot <r, r>. Each row is read
//   and written by one thread only, so x and r are updated in place.
//
// Dots without float atomics: each block writes one partial; the last block
// to finish (an integer ticket) sums the partials in a fixed order and
// updates the scalars — kernel A sets pq and alpha = rho / (pq == 0 ? 1 : pq),
// kernel B sets rho_prev = rho, rho = <r, r>. The grid size depends only on
// m_pad, so a repeated solve gives bit-identical iterates.
//
// What bounds it: memory. Per row and iteration kernel A streams r and p
// (the D shifted reads hit L1/L2), D planes, and writes p_new and q; kernel
// B reads x, p, r, q and writes x and r: (2 + D + 2 + 4 + 2) values, 60 bytes
// per row at D = 5 in f32, about 2.16 GB per iteration at 6000^2.
//
// Design: grid-stride loops with a fixed grid of at most 1024 blocks of 256
// threads (enough resident warps to keep HBM busy on 132 SMs), coalesced
// streams, the shifted r/p reads through the read-only cache. A staged
// shared-memory halo window is left for later: at 6000^2 the band is 6000
// rows, so a 1024-row tile would stage ~13x its own rows. Elementwise
// results use explicitly rounded operations, so p_new, q, x and r equal the
// plain torch version bit for bit given the same scalars.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

// Every block adds its value v to partials; the block that finishes last
// returns true with the fixed-order grid total in *total (thread 0) and
// rearms the ticket for the next launch.
template <typename T>
__device__ bool grid_sum_last(T v, T* partials, unsigned int* ticket, T* total) {
  __shared__ bool is_last;
  const T s = block_sum(v);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  T t = T(0);
  for (unsigned int b = threadIdx.x; b < gridDim.x; b += kThreads) t += __ldcg(partials + b);
  t = block_sum(t);
  if (threadIdx.x == 0) {
    *total = t;
    *ticket = 0u;
  }
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_kernel_a(const T* __restrict__ planes, const T* __restrict__ r,
            const T* __restrict__ p, T* __restrict__ pnew, T* __restrict__ q,
            T* partials, unsigned int* ticket, T* sc, long long m_pad, long long B,
            StkOffsets offs, int D) {
  const T rho_prev = sc[0], rho = sc[1];
  const T beta = rho_prev == T(0) ? T(0) : rho / rho_prev;
  const long long stride = (long long)gridDim.x * kThreads;
  T dot = T(0);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m_pad; i += stride) {
    const long long c = B + i;
    T acc = T(0);
    for (int k = 0; k < D; ++k) {
      const long long j = c + offs.o[k];
      const T pw = add_rn(__ldg(r + j), mul_rn(beta, __ldg(p + j)));
      acc = add_rn(acc, mul_rn(planes[(long long)k * m_pad + i], pw));
    }
    const T mid = add_rn(__ldg(r + c), mul_rn(beta, __ldg(p + c)));
    pnew[c] = mid;
    q[c] = acc;
    dot += mid * acc;
  }
  T pq;
  if (grid_sum_last(dot, partials, ticket, &pq) && threadIdx.x == 0) {
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
  T dot = T(0);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m_pad; i += stride) {
    const long long c = B + i;
    x[c] = add_rn(x[c], mul_rn(alpha, p[c]));
    const T rn = sub_rn(r[c], mul_rn(alpha, q[c]));
    r[c] = rn;
    dot += rn * rn;
  }
  T rr;
  if (grid_sum_last(dot, partials, ticket, &rr) && threadIdx.x == 0) {
    sc[0] = sc[1];
    sc[1] = rr;
  }
}

int check_grid(long long m_pad, int nblocks) {
  if (m_pad <= 0 || nblocks < 1 || nblocks > 1024) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int launch_a(const T* planes, const T* r, const T* p, T* pnew, T* q, T* partials,
             unsigned int* ticket, T* sc, long long m_pad, long long B,
             const long long* offsets, int D, int nblocks, void* stream) {
  StkOffsets offs;
  int err = stk_copy_offsets(&offs, offsets, D);
  if (!err) err = check_grid(m_pad, nblocks);
  if (err) return err;
  cg_kernel_a<T><<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
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

}  // namespace

extern "C" {

int stk_cg_kernel_a_f32(const float* planes, const float* r, const float* p, float* pnew,
                        float* q, float* partials, unsigned int* ticket, float* sc,
                        long long m_pad, long long B, const long long* offsets, int D,
                        int nblocks, void* stream) {
  return launch_a<float>(planes, r, p, pnew, q, partials, ticket, sc, m_pad, B, offsets,
                         D, nblocks, stream);
}

int stk_cg_kernel_b_f32(float* x, float* r, const float* p, const float* q,
                        float* partials, unsigned int* ticket, float* sc, long long m_pad,
                        long long B, int nblocks, void* stream) {
  return launch_b<float>(x, r, p, q, partials, ticket, sc, m_pad, B, nblocks, stream);
}

const char* stk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
