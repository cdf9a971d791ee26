// Chunked SELL SpMV for Hopper (sm_90a), single and batched: one launch per
// product.
//
// Replaces sparse_tpu/kernels/sell_spmv.py::_sell_slab_pallas (pallas_call
// at :226, via sell_spmv_pallas) and ::_sell_slab_pallas_batched (pallas_call
// at :293, via sell_spmv_pallas_batched). The TPU kernels run slab by slab
// over the reference's SELL-C-sigma pack; these run the whole product in one
// launch over the card's own layout (kernels/sell_spmv.py::sell_chunk_pack):
//
//   * rows sorted once by descending degree (perm, ties in row order), cut
//     into chunks of 32 rows (one warp), each chunk at its own width w_c;
//   * chunk c's slots at cptr[c] + k * 32 + r (slot-major: a warp reads 128
//     contiguous bytes of index and of value per slot step), pad slots hold
//     index 0 and value 0;
//   * a work list of int4 {chunk, segment, segments of the chunk, first
//     partial row}: segment s of chunk c covers slots [s * S, min((s + 1) *
//     S, w_c)), every chunk at least one segment.
//
// The single-matrix kernel gives each warp one work item, one lane per row:
// it sums the segment's slots in slot order with explicitly rounded
// multiply/add. A chunk of one segment writes y[perm[row]] straight away; a
// split chunk's warps write partials, and the last warp to take the chunk's
// integer ticket sums the partials in segment order, writes y and rearms the
// ticket. No float atomics: the order of every sum is fixed by the layout,
// so the result equals the plain version (ops/spmv.py::csr_spmv_chunks) bit
// for bit and repeats are bit-identical.
//
// The batched kernel runs the same work list over B lanes that share the
// index slots: values [slots, B], x [n, B], y [B, m]. A block takes one work
// item and a group of up to 64 lanes; its threads run across (row, lane)
// pairs, lanes fastest, so one index load serves a warp of lanes and one x
// gather reads 32 lanes in 128 contiguous bytes. Each (row, lane) pair is
// summed in the single-matrix kernel's order: a lane equals the lone
// product bit for bit.
//
// What bounds it: memory. Each stored slot's index and value is read once
// (about 1.02 slots a nonzero for a power-law matrix), x is gathered, y and
// perm are touched once a row. The single-matrix x gather reads one 32-byte
// sector per value; the batched one 128 bytes per 32 lanes. Index and value
// slots stream through with evict-first loads (__ldcs), so that x, read
// again and again, stays in L2.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRows = 32;        // rows a chunk: one warp
constexpr int kWarps = 8;        // warps a block of the single-matrix kernel
constexpr int kThreads = 256;    // threads a block of the batched kernel
constexpr int kLaneGroup = 64;   // lanes a block of the batched kernel
constexpr int kPairs = kRows * kLaneGroup / kThreads;  // (row, lane) pairs a thread

template <typename T, typename I>
__global__ void __launch_bounds__(kWarps * 32)
sell_chunk_kernel(const I* __restrict__ idx, const T* __restrict__ val,
                  const T* __restrict__ x, T* __restrict__ y, const I* __restrict__ perm,
                  const long long* __restrict__ cptr, const int4* __restrict__ work,
                  T* __restrict__ partials, unsigned int* __restrict__ tickets, long long m,
                  long long nwork, int seg) {
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= nwork) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int4 wk = work[w];
  const long long base = cptr[wk.x];
  const long long width = (cptr[wk.x + 1] - base) / kRows;
  const long long k0 = (long long)wk.y * seg;
  const long long k1 = k0 + seg < width ? k0 + seg : width;
  const I* ip = idx + base + lane;
  const T* vp = val + base + lane;

  T acc = T(0);
#pragma unroll 4
  for (long long k = k0; k < k1; ++k) {
    acc = add_rn(acc, mul_rn(__ldcs(vp + k * kRows), __ldg(x + __ldcs(ip + k * kRows))));
  }
  const long long row = (long long)wk.x * kRows + lane;
  if (wk.z == 1) {
    if (row < m) y[perm[row]] = acc;
    return;
  }
  partials[((long long)wk.w + wk.y) * kRows + lane] = acc;
  __threadfence();
  __syncwarp();
  unsigned int last = 0u;
  if (lane == 0) last = atomicAdd(tickets + wk.w, 1u) == (unsigned int)wk.z - 1u;
  last = __shfl_sync(0xffffffffu, last, 0);
  if (!last) return;
  __threadfence();
  const T* pb = partials + (long long)wk.w * kRows + lane;
  T s = __ldcg(pb);
  for (int j = 1; j < wk.z; ++j) s = add_rn(s, __ldcg(pb + (long long)j * kRows));
  if (row < m) y[perm[row]] = s;
  if (lane == 0) tickets[wk.w] = 0u;  // rearm for the next launch
}

// At most 80 registers a thread, so 3 blocks (24 warps) share an SM: the
// loads in flight, not the registers, decide this kernel's pace.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads, 3)
sell_chunk_batched_kernel(const I* __restrict__ idx, const T* __restrict__ val,
                          const T* __restrict__ xt, T* __restrict__ y, const I* __restrict__ perm,
                          const long long* __restrict__ cptr, const int4* __restrict__ work,
                          T* __restrict__ partials, unsigned int* __restrict__ tickets,
                          long long m, int B, int seg) {
  __shared__ int s_last;
  const int4 wk = work[blockIdx.x];
  const int g = blockIdx.y;
  const int b0 = g * kLaneGroup;
  const int L = B - b0 < kLaneGroup ? B - b0 : kLaneGroup;  // lanes of this group
  const int npairs = kRows * L;
  const long long base = cptr[wk.x];
  const long long width = (cptr[wk.x + 1] - base) / kRows;
  const long long k0 = (long long)wk.y * seg;
  const long long k1 = k0 + seg < width ? k0 + seg : width;

  // pair q of the block: row q / L, lane b0 + q % L. A thread past the
  // group's pairs repeats pair 0 and writes nothing, so the loop below has
  // no branch and issues all its pairs' loads together.
  int r[kPairs], b[kPairs];
  T acc[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int q = threadIdx.x + j * kThreads < npairs ? threadIdx.x + j * kThreads : 0;
    r[j] = q / L;
    b[j] = b0 + q % L;
    acc[j] = T(0);
  }
  for (long long k = k0; k < k1; ++k) {
    const long long slot0 = base + k * kRows;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const long long s = slot0 + r[j];
      const long long col = (long long)__ldcs(idx + s);
      acc[j] = add_rn(acc[j], mul_rn(__ldcs(val + s * B + b[j]), __ldg(xt + col * B + b[j])));
    }
  }
  const long long row0 = (long long)wk.x * kRows;
  if (wk.z == 1) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      if (threadIdx.x + j * kThreads < npairs && row0 + r[j] < m) {
        y[(long long)b[j] * m + perm[row0 + r[j]]] = acc[j];
      }
    }
    return;
  }
  T* pb = partials + ((long long)wk.w + wk.y) * kRows * B;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    if (threadIdx.x + j * kThreads < npairs) pb[(long long)r[j] * B + b[j]] = acc[j];
  }
  __threadfence();
  __syncthreads();
  unsigned int* ticket = tickets + (long long)wk.w * gridDim.y + g;
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == (unsigned int)wk.z - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const T* p0 = partials + (long long)wk.w * kRows * B;
  const long long stride = (long long)kRows * B;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    if (threadIdx.x + j * kThreads < npairs) {
      const T* pp = p0 + (long long)r[j] * B + b[j];
      T s = __ldcg(pp);
      for (int i = 1; i < wk.z; ++i) s = add_rn(s, __ldcg(pp + i * stride));
      if (row0 + r[j] < m) y[(long long)b[j] * m + perm[row0 + r[j]]] = s;
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;  // rearm for the next launch
}

template <typename T, typename I>
int launch(const I* idx, const T* val, const T* x, T* y, const I* perm, const long long* cptr,
           const int* work, T* partials, unsigned int* tickets, long long m, long long nwork,
           int seg, int lanes, bool batched, void* stream) {
  if (m < 1 || nwork < 1 || seg < 1 || lanes < 1 || (!batched && lanes != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int4* wk = reinterpret_cast<const int4*>(work);
  if (!batched) {
    const long long blocks = (nwork + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    sell_chunk_kernel<T, I><<<(unsigned int)blocks, kWarps * 32, 0, s>>>(
        idx, val, x, y, perm, cptr, wk, partials, tickets, m, nwork, seg);
  } else {
    const long long groups = (lanes + kLaneGroup - 1) / kLaneGroup;
    if (nwork > 0x7fffffffLL || groups > 65535) return (int)cudaErrorInvalidValue;
    sell_chunk_batched_kernel<T, I><<<dim3((unsigned int)nwork, (unsigned int)groups), kThreads, 0, s>>>(
        idx, val, x, y, perm, cptr, wk, partials, tickets, m, lanes, seg);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point per (kernel, value dtype, index dtype); each wrapper counts
// its own launches. The single-matrix entry points take one lane; the batched
// ones take x as [n, lanes] and write y as [lanes, m].
#define STK_SELL_ENTRY(NAME, T, I, BATCHED)                                                  \
  extern "C" int NAME(const I* idx, const T* val, const T* x, T* y, const I* perm,           \
                      const long long* cptr, const int* work, T* partials,                   \
                      unsigned int* tickets, long long m, long long nwork, int seg,          \
                      int lanes, void* stream) {                                             \
    return launch<T, I>(idx, val, x, y, perm, cptr, work, partials, tickets, m, nwork, seg, \
                        lanes, BATCHED, stream);                                             \
  }

STK_SELL_ENTRY(stk_sell_chunk_spmv_f32_i32, float, int, false)
STK_SELL_ENTRY(stk_sell_chunk_spmv_f32_i64, float, long long, false)
STK_SELL_ENTRY(stk_sell_chunk_spmv_f64_i32, double, int, false)
STK_SELL_ENTRY(stk_sell_chunk_spmv_f64_i64, double, long long, false)
STK_SELL_ENTRY(stk_sell_chunk_spmv_batched_f32_i32, float, int, true)
STK_SELL_ENTRY(stk_sell_chunk_spmv_batched_f32_i64, float, long long, true)
STK_SELL_ENTRY(stk_sell_chunk_spmv_batched_f64_i32, double, int, true)
STK_SELL_ENTRY(stk_sell_chunk_spmv_batched_f64_i64, double, long long, true)

extern "C" const char* stk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
