// SELL-C-sigma slab SpMV for Hopper (sm_90a), single and batched.
//
// Replaces sparse_tpu/kernels/sell_spmv.py::_sell_slab_pallas (pallas_call
// at :226, via sell_spmv_pallas) and ::_sell_slab_pallas_batched (pallas_call
// at :293, via sell_spmv_pallas_batched). For one slab of plane-major [K, R]
// index/value planes it computes, for every slab row r and lane b,
//
//     y[b * ldy + r] = sum_k val[b][k * R + r] * x[b * n + idx[k * R + r]]
//
// The single-matrix entry points launch it with one lane; the batched ones
// with B lanes that share the index planes (pattern state) and stream their
// own [K, R] value planes and x.
//
// What bounds it: memory. Every stored slot is read once (its index and its
// value), x is gathered (at 2^21 rows x is 8 MB and stays in the 50 MB L2),
// y is written once. At skewed_degree_csr(2^21), f32, the 16-slab pack holds
// 159e6 slots: about 1.28 GB per call, of which a third is padding.
//
// Design: rows sit on consecutive threads, so each plane's index and value
// loads are coalesced (that is what the plane-major layout is for); x is
// read through the read-only path (__ldg). Two shapes, chosen per slab by
// the wrapper (kernels/sell_spmv.py::sell_split) from K and R alone, so a
// lane of the batched kernel sums in the single-matrix kernel's order:
//   * narrow (W = 1, nblk = 1): 256-row blocks, one thread per row summing
//     k = 0 .. K-1 in plane order with explicitly rounded multiply/add, so
//     the result equals the plain torch version bit for bit;
//   * split-K: 32-row blocks of W warps. The K range is cut into segments
//     of KS planes; warp w of block (tile, j) sums segment j * W + w for its
//     32 rows, the W warp partials are summed in warp order in shared
//     memory, and when one block cannot cover K (nblk > 1) each block writes
//     its partial and the last block of the tile to take an integer ticket
//     sums the nblk partials in block order. No float atomics: the order of
//     every sum is fixed by (K, R, KS, W, nblk), so repeats are bit-identical.
// The wide slabs of a power-law matrix (K = 131072 with R = 128) would
// otherwise put 131072 dependent gathers on each of 128 threads.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kNarrowThreads = 256;
constexpr int kTileRows = 32;
constexpr int kMaxWarps = 8;

template <typename T, typename I>
__global__ void __launch_bounds__(256)
sell_slab_kernel(const I* __restrict__ idx, const T* __restrict__ val,
                 const T* __restrict__ x, T* __restrict__ y,
                 T* __restrict__ partials, unsigned int* __restrict__ tickets,
                 long long K, long long R, long long n, long long ldy, long long KS,
                 int nblk) {
  const long long lane = blockIdx.z;
  const int W = blockDim.y;
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long seg = (long long)blockIdx.y * W + threadIdx.y;
  const long long k0 = seg * KS;
  const long long k1 = k0 + KS < K ? k0 + KS : K;
  const T* vb = val + lane * K * R;
  const T* xb = x + lane * n;
  T* yb = y + lane * ldy;

  T acc = T(0);
  if (row < R) {
#pragma unroll 4
    for (long long k = k0; k < k1; ++k) {
      const long long s = k * R + row;
      acc = add_rn(acc, mul_rn(vb[s], __ldg(xb + idx[s])));
    }
  }
  if (W == 1 && nblk == 1) {  // narrow: the plane-order sum is the result
    if (row < R) yb[row] = acc;
    return;
  }

  __shared__ T part[kMaxWarps][kTileRows];
  __shared__ bool is_last;
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && row < R) {
    T s = part[0][threadIdx.x];
    for (int w = 1; w < W; ++w) s = add_rn(s, part[w][threadIdx.x]);
    if (nblk == 1) {
      yb[row] = s;
    } else {
      partials[(lane * nblk + blockIdx.y) * R + row] = s;
    }
  }
  if (nblk == 1) return;
  __threadfence();
  __syncthreads();
  unsigned int* ticket = tickets + lane * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    is_last = atomicAdd(ticket, 1u) == (unsigned int)nblk - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.y == 0 && row < R) {
    const T* pb = partials + lane * nblk * R + row;
    T s = __ldcg(pb);
    for (int j = 1; j < nblk; ++j) s = add_rn(s, __ldcg(pb + (long long)j * R));
    yb[row] = s;
  }
  if (threadIdx.x == 0 && threadIdx.y == 0) *ticket = 0u;  // rearm for the next launch
}

template <typename T, typename I>
int launch(const I* idx, const T* val, const T* x, T* y, T* partials,
           unsigned int* tickets, long long K, long long R, long long n, long long ldy,
           long long KS, int W, int nblk, int lanes, void* stream) {
  if (K < 1 || R < 1 || KS < 1 || W < 1 || W > kMaxWarps || nblk < 1 || nblk > 65535 ||
      lanes < 1 || lanes > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (W == 1 && nblk == 1) {
    const long long blocks = (R + kNarrowThreads - 1) / kNarrowThreads;
    sell_slab_kernel<T, I><<<dim3((unsigned int)blocks, 1, lanes), dim3(kNarrowThreads, 1), 0, s>>>(
        idx, val, x, y, partials, tickets, K, R, n, ldy, K, 1);
  } else {
    const long long tiles = (R + kTileRows - 1) / kTileRows;
    sell_slab_kernel<T, I><<<dim3((unsigned int)tiles, nblk, lanes), dim3(kTileRows, W), 0, s>>>(
        idx, val, x, y, partials, tickets, K, R, n, ldy, KS, nblk);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point per (kernel, value dtype, index dtype). The single-matrix
// kernel is the batched one at one lane; each wrapper counts its own launches.
#define STK_SELL_ENTRY(NAME, T, I, LANES)                                                \
  extern "C" int NAME(const I* idx, const T* val, const T* x, T* y, T* partials,       \
                      unsigned int* tickets, long long K, long long R, long long n,    \
                      long long ldy, long long KS, int W, int nblk, int lanes,         \
                      void* stream) {                                                  \
    return launch<T, I>(idx, val, x, y, partials, tickets, K, R, n, ldy, KS, W, nblk,  \
                        LANES, stream);                                                \
  }

STK_SELL_ENTRY(stk_sell_spmv_slab_f32_i32, float, int, 1)
STK_SELL_ENTRY(stk_sell_spmv_slab_f32_i64, float, long long, 1)
STK_SELL_ENTRY(stk_sell_spmv_slab_f64_i32, double, int, 1)
STK_SELL_ENTRY(stk_sell_spmv_slab_f64_i64, double, long long, 1)
STK_SELL_ENTRY(stk_sell_spmv_slab_batched_f32_i32, float, int, lanes)
STK_SELL_ENTRY(stk_sell_spmv_slab_batched_f32_i64, float, long long, lanes)
STK_SELL_ENTRY(stk_sell_spmv_slab_batched_f64_i32, double, int, lanes)
STK_SELL_ENTRY(stk_sell_spmv_slab_batched_f64_i64, double, long long, lanes)

extern "C" const char* stk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
