// Fused CG iterations for Hopper (sm_90a): the two-pass iteration (kernels A
// and B) and the one-pass Chronopoulos-Gear iteration (kernel CGCG, in two
// forms: the windowed kernel and, for bands its window cannot hold, the
// wide kernel).
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
//   read and written by the one thread that owns the row and are updated
//   in place. The last block sets rho_prev = rho, rho = <r', r'>, mu =
//   <w', r'> and alpha_prev = alpha == 0 ? 1 : alpha.
//
// Dots without float atomics: each block writes its partials; the last block
// to finish (an integer ticket) sums them in a fixed order and updates the
// scalars. The grid size depends only on the plan and the card (never on a
// timing), so a repeated solve gives bit-identical iterates.
//
// What bounds them: memory. Per row and iteration kernel A streams r and p
// (the D shifted reads hit L1/L2), D planes, and writes p_new and q; kernel
// B reads x, p, r, q and writes x and r: (2 + D + 2 + 4 + 2) values, 60 bytes
// per row at D = 5 in f32, about 2.16 GB per iteration at 6000^2. Kernel
// CGCG reads r, w, s, p, x and D planes and writes r', w', s', p, x: the
// same 15 values a row in one launch and one grid-wide reduction instead of
// two; bf16 planes take 10 of its 60 bytes off.
//
// Kernels A and B: grid-stride loops with a fixed grid of at most 1024
// blocks of 256 threads (enough resident warps to keep HBM busy on 132
// SMs), coalesced streams, the shifted reads through the read-only cache.
//
// The windowed CGCG kernel: its grid-stride predecessor (now the wide
// kernel) read r, w and s at every row i + o_k through L1/L2 and recomputed
// s' and r' there, 3 (D + 1) loads a row for the 3 the function needs, and
// reached half its byte bound. Here the grid is persistent and each block
// owns a contiguous range [R0, R1) of rows, a whole number of 1024-row
// tiles (256 threads x 4 rows). With lo = min(0, min o_k) and hi = max(0,
// max o_k), both rounded out to a multiple of 4, and span = hi - lo, a ring
// of r' values in dynamic shared memory covers the rows the current tile
// reads: the block first computes r' for [R0 + lo, R0 + hi) (the prefill),
// then each tile step loads r, w and s once for the 1024 rows that enter
// the window, stores their r' in the ring and computes w' for its own 1024
// rows from the ring alone. So every row's r, w and s are loaded once, plus
// one band's rows a block at the start of its range (the prefill: 3 span
// values a block, 76 MB an iteration at 6000^2 with 528 blocks, 57 MB with
// 396, 2.6-3.5% of the 2.16 GB the function moves). The owner of a row (the
// thread whose entering group it is, in the prefill or a tile step) writes
// its r', s', p and x; every interior row is written once and halo rows
// never. Streams are 16-byte loads and stores of 4 rows (B and m_pad are
// multiples of 4); a thread's 4 ring values are one or two aligned 16-byte
// shared loads, conflict-free across the warp in f32. The next tile's
// entering rows are in flight while the current tile's planes stream and
// its w' is computed: copied one step earlier still by cp.async into a
// staging area (kAsync, f32 vectors), or in registers (kAhead, f64). The
// ring holds span + 2 tiles: 56 KB in f32 at 6000^2 (+ 20 KB of staging: 3
// blocks an SM) and 112 KB in f64 (2 an SM). Measured on an H100 80GB HBM3
// at 700 W at 6000^2 (PERF.md): f32 0.818 ms, 79% of its 0.645 ms byte
// bound (the grid-stride kernel 1.309 ms); f64 1.567 ms, 82%. The
// one-pass iteration runs the wide kernel, the grid-stride one above, on a
// band whose window does not fit a block's shared memory (f32 past a span
// of about 51,000 rows, f64 past about 27,000) and where a block owns fewer
// than 1.5 spans of rows: there the prefill costs more than the window
// saves (kernels/cg_dia.py, WINDOW_MIN_RATIO). Both kernels are
// bit-identical to the plain version.
//
// Elementwise results and the scalar recurrence use explicitly rounded
// operations, so the vectors equal the plain torch versions bit for bit
// given the same scalars.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
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

// The CG-CG scalars of this iteration from sc = {rho_prev, rho, mu,
// alpha_prev}, with the reference's zero guards. Every block reads sc
// before its ticket; the last block, which writes sc, takes its ticket
// after all of them.
template <typename T>
struct CgcgScalars {
  T rho, alpha, beta;
  __device__ explicit CgcgScalars(const T* sc) {
    const T rho_prev = sc[0], mu = sc[2], alpha_prev = sc[3];
    rho = sc[1];
    beta = rho_prev == T(0) ? T(0) : rho / rho_prev;
    const T ratio = alpha_prev == T(0) ? T(0) : beta / alpha_prev;
    const T denom = sub_rn(mu, mul_rn(ratio, rho));
    alpha = denom == T(0) ? T(0) : rho / denom;
  }
  // run by the last block's thread 0 with the grid totals of the two dots
  __device__ void publish(T* sc, const T (&dots)[2]) const {
    sc[0] = rho;
    sc[1] = dots[0];
    sc[2] = dots[1];
    sc[3] = alpha == T(0) ? T(1) : alpha;
  }
};

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
cgcg_wide_kernel(const P* __restrict__ planes, const T* __restrict__ r, const T* __restrict__ w,
                 const T* __restrict__ s, T* __restrict__ p, T* __restrict__ x,
                 T* __restrict__ r_out, T* __restrict__ w_out, T* __restrict__ s_out,
                 T* partials, unsigned int* ticket, T* sc, long long m_pad, long long B,
                 StkOffsets offs, int D) {
  const CgcgScalars<T> sk(sc);
  const T alpha = sk.alpha, beta = sk.beta;
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
  if (grid_sums_last(dots, partials, ticket) && threadIdx.x == 0) sk.publish(sc, dots);
}

// ---------------------------------------------------------------------------
// The windowed one-pass kernel
// ---------------------------------------------------------------------------
constexpr int kRows = 4;                 // consecutive rows a thread, one 16-byte group
constexpr int kTile = kThreads * kRows;  // rows a tile step

// 16-byte loads and stores of 4 consecutive values (f64: two of them)
__device__ __forceinline__ void ldg4(const float* q, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(q));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void ldg4(const double* q, double (&v)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(q));
  const double2 b = __ldg(reinterpret_cast<const double2*>(q) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
// the plane streams: read once, evict first; bf16 widens exactly to f32
__device__ __forceinline__ void ldcs4(const float* q, float (&v)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(q));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void ldcs4(const double* q, double (&v)[4]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(q));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(q) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void ldcs4(const __nv_bfloat16* q, float (&v)[4]) {
  const uint2 a = __ldcs(reinterpret_cast<const uint2*>(q));  // the lower address in the low half
  v[0] = __uint_as_float(a.x << 16), v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16), v[3] = __uint_as_float(a.y & 0xffff0000u);
}
// p and x: read and written in this launch, so not through the read-only path
__device__ __forceinline__ void ld4(const float* q, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void ld4(const double* q, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(q)[0];
  const double2 b = reinterpret_cast<const double2*>(q)[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void st4(float* q, const float (&v)[4]) {
  *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* q, const double (&v)[4]) {
  reinterpret_cast<double2*>(q)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(q)[1] = make_double2(v[2], v[3]);
}

// The 4 ring values at window positions q + tid4 .. q + tid4 + 3 of the
// tile whose first output row sits in slot `head` (slots wrap at len, a
// multiple of 4). The shift q & 3 is the same across the block, so an
// unaligned read is two aligned group loads and a fixed selection.
template <typename T>
__device__ __forceinline__ void ring4(const T* ring, int head, int q, int tid4, int len,
                                      T (&v)[4]) {
  int g = head + (q & ~3) + tid4;
  if (g >= len) g -= len;
  T a[4];
  ld4(ring + g, a);
  const int shift = q & 3;
  if (shift == 0) {
    v[0] = a[0], v[1] = a[1], v[2] = a[2], v[3] = a[3];
    return;
  }
  const int g2 = g + 4 == len ? 0 : g + 4;
  T b[4];
  ld4(ring + g2, b);
  if (shift == 1) {
    v[0] = a[1], v[1] = a[2], v[2] = a[3], v[3] = b[0];
  } else if (shift == 2) {
    v[0] = a[2], v[1] = a[3], v[2] = b[0], v[3] = b[1];
  } else {
    v[0] = a[3], v[1] = b[0], v[2] = b[1], v[3] = b[2];
  }
}

// One thread's group of 4 rows entering the window: r, w and s loaded once;
// s' = w + beta s and r' = r - alpha s' into the ring; where the block owns
// the rows, r' and s' written and p = r + beta p, x += alpha p in place.
template <typename T>
struct Entering {
  T r[4], w[4], s[4], p[4], x[4];
  long long c;     // padded index of the first row
  bool live, own;  // needed by an output row of the range; owned by the block

  __device__ void load(const T* rv, const T* wv, const T* sv, const T* pv, const T* xv) {
    if (live) {
      ldg4(rv + c, r);
      ldg4(wv + c, w);
      ldg4(sv + c, s);
    }
    if (own) {
      ld4(pv + c, p);
      ld4(xv + c, x);
    }
  }

  __device__ void commit(T* slot, T* r_out, T* s_out, T* pv, T* xv, T alpha, T beta) {
    if (!live) return;
    T rn[4], sn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sn[j] = add_rn(w[j], mul_rn(beta, s[j]));
      rn[j] = sub_rn(r[j], mul_rn(alpha, sn[j]));
    }
    st4(slot, rn);
    if (!own) return;
    st4(r_out + c, rn);
    st4(s_out + c, sn);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T p_new = add_rn(r[j], mul_rn(beta, p[j]));
      x[j] = add_rn(x[j], mul_rn(alpha, p_new));
      p[j] = p_new;
    }
    st4(pv + c, p);
    st4(xv + c, x);
  }

  // the same loads as cp.async copies into the thread's own 16-byte slots of
  // a [5][kTile] staging area (r, w, s, p, x); unstage() reads them back
  // after the copies are waited for (each thread reads only what it copied)
  __device__ void stage(T* st, int tid4, const T* rv, const T* wv, const T* sv, const T* pv,
                        const T* xv) const {
    if (live) {
      copy4(st + tid4, rv + c);
      copy4(st + kTile + tid4, wv + c);
      copy4(st + 2 * kTile + tid4, sv + c);
    }
    if (own) {
      copy4(st + 3 * kTile + tid4, pv + c);
      copy4(st + 4 * kTile + tid4, xv + c);
    }
  }

  __device__ void unstage(const T* st, int tid4) {
    if (live) {
      ld4(st + tid4, r);
      ld4(st + kTile + tid4, w);
      ld4(st + 2 * kTile + tid4, s);
    }
    if (own) {
      ld4(st + 3 * kTile + tid4, p);
      ld4(st + 4 * kTile + tid4, x);
    }
  }

  __device__ static void copy4(T* dst, const T* src) {
#pragma unroll
    for (int b = 0; b < (int)(4 * sizeof(T)); b += 16) {
      __pipeline_memcpy_async(reinterpret_cast<char*>(dst) + b,
                              reinterpret_cast<const char*>(src) + b, 16);
    }
  }
};

// w' = sum_k plane_k * r'[i + o_k] (in k order) for the thread's 4 output
// rows from i, r' read from the ring only; the two dots' terms.
template <typename T, typename P>
__device__ __forceinline__ void output_rows(const P* __restrict__ planes, const T* ring,
                                            T* __restrict__ w_out, long long m_pad, long long B,
                                            const StkOffsets& offs, int D, int lo, int head,
                                            int len, int tid4, long long i, T (&dots)[2]) {
  T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    T pl[4], rv[4];
    ldcs4(planes + (long long)k * m_pad + i, pl);
    ring4(ring, head, (int)(offs.o[k] - lo), tid4, len, rv);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = add_rn(acc[j], mul_rn(pl[j], rv[j]));
  }
  T rm[4];
  ring4(ring, head, -lo, tid4, len, rm);
  st4(w_out + B + i, acc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dots[0] += rm[j] * rm[j];
    dots[1] += acc[j] * rm[j];
  }
}

// The schedule of a tile step, by vector type (the faster of the two at
// 6000^2 in each; PERF.md has the times):
//   kAhead (f64): load the next tile's entering rows into registers, compute
//     the current tile's output rows while they arrive, commit them, wait;
//   kAsync (f32): the same, with the entering rows of the tile after next
//     copied by cp.async into a staging area of 5 tiles (r, w, s, p, x)
//     while a whole step runs. In f64 that area would leave one block an
//     SM at 6000^2, which ran slower.
// Either way the ring holds span + 2 tiles and a tile takes one barrier.
// (A schedule that loads, commits, waits, computes and waits, with a ring
// of span + 1 tile, ran slower in every dtype.)
enum Schedule { kAhead, kAsync };
template <typename T>
constexpr int kSchedule = sizeof(T) == 4 ? kAsync : kAhead;
constexpr int kRingTiles = 2;
template <typename T>
constexpr int kWindowTiles = kRingTiles + (kSchedule<T> == kAsync ? 5 : 0);

// Registers are capped so that the 6000^2 window's residency (3 blocks an SM
// in f32, 2 in f64) is what shared memory allows, for f32 and bf16 planes
// alike.
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
cgcg_window_kernel(const P* __restrict__ planes, const T* __restrict__ r,
                   const T* __restrict__ w, const T* __restrict__ s, T* __restrict__ p,
                   T* __restrict__ x, T* __restrict__ r_out, T* __restrict__ w_out,
                   T* __restrict__ s_out, T* partials, unsigned int* ticket, T* sc,
                   long long m_pad, long long B, StkOffsets offs, int D, int lo, int span) {
  constexpr int kSched = kSchedule<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int len = span + kRingTiles * kTile;
  T* stage = ring + len;  // kAsync only
  const CgcgScalars<T> sk(sc);
  const T alpha = sk.alpha, beta = sk.beta;
  const int hi = lo + span, tid4 = threadIdx.x * kRows;
  // the block's rows: whole tiles, split as evenly as the tile count allows
  const long long ntiles = (m_pad + kTile - 1) / kTile;
  const long long R0 = (long long)blockIdx.x * ntiles / gridDim.x * kTile;
  const long long R1 = min((long long)(blockIdx.x + 1) * ntiles / gridDim.x * kTile, m_pad);
  // the thread's entering group of the tile starting at t
  auto entering = [&](long long t) {
    Entering<T> e;
    const long long row = t + hi + tid4;
    e.c = B + row;
    e.live = row < R1 + hi;
    e.own = row < R1;
    return e;
  };
  T dots[2] = {T(0), T(0)};
  if (R0 < R1) {
    // prefill: r' of rows [R0 + lo, R0 + hi) into slots [0, span)
    for (int g = tid4; g < span; g += kTile) {
      Entering<T> e;
      const long long row = R0 + lo + g;
      e.c = B + row;
      e.live = true;
      e.own = row >= R0 && row < R1;
      e.load(r, w, s, p, x);
      e.commit(ring + g, r_out, s_out, p, x, alpha, beta);
    }
    // the first tile's entering rows go to slots [span, span + kTile)
    Entering<T> e = entering(R0);
    e.load(r, w, s, p, x);
    if constexpr (kSched == kAsync) {
      entering(R0 + kTile).stage(stage, tid4, r, w, s, p, x);
      __pipeline_commit();
    }
    e.commit(ring + span + tid4, r_out, s_out, p, x, alpha, beta);
    __syncthreads();
    int head = 0;  // slot of the current tile's first output row
    for (long long t = R0; t < R1; t += kTile) {
      Entering<T> nx = entering(t + kTile);
      if constexpr (kSched == kAhead) nx.load(r, w, s, p, x);
      if (t + tid4 < R1) {
        output_rows(planes, ring, w_out, m_pad, B, offs, D, lo, head, len, tid4, t + tid4, dots);
      }
      if constexpr (kSched == kAsync) {
        __pipeline_wait_prior(0);
        nx.unstage(stage, tid4);
      }
      // the next tile's entering rows overwrite the slots of this tile's
      // first kTile window positions, which no output row reads any more
      int slot = head + kTile + span + tid4;
      nx.commit(ring + (slot >= len ? slot - len : slot), r_out, s_out, p, x, alpha, beta);
      if constexpr (kSched == kAsync) {
        // after the commit has used the unstaged values: the slots are free
        entering(t + 2 * kTile).stage(stage, tid4, r, w, s, p, x);
        __pipeline_commit();
      }
      __syncthreads();
      head += kTile;
      if (head >= len) head -= len;
    }
    if constexpr (kSched == kAsync) __pipeline_wait_prior(0);
  }
  if (grid_sums_last(dots, partials, ticket) && threadIdx.x == 0) sk.publish(sc, dots);
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
int launch_cgcg_wide(const P* planes, const T* r, const T* w, const T* s, T* p, T* x,
                     T* r_out, T* w_out, T* s_out, T* partials, unsigned int* ticket, T* sc,
                     long long m_pad, long long B, const long long* offsets, int D, int nblocks,
                     void* stream) {
  StkOffsets offs;
  int err = stk_copy_offsets(&offs, offsets, D);
  if (!err) err = check_grid(m_pad, nblocks);
  if (err) return err;
  cgcg_wide_kernel<T, P><<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      planes, r, w, s, p, x, r_out, w_out, s_out, partials, ticket, sc, m_pad, B, offs, D);
  return (int)cudaGetLastError();
}

// The card's numbers the window's geometry needs: out = {SMs, the most
// dynamic shared memory a block of the kernel may take (which this call
// also allows it), resident blocks an SM with shared_bytes of it (0 when
// they do not fit)}.
template <typename T, typename P>
int window_limits(long long shared_bytes, int* out) {
  const auto kernel = cgcg_window_kernel<T, P>;
  int dev = 0, sms = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (!e) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!e) e = cudaFuncGetAttributes(&fa, kernel);
  if (e) return (int)e;
  const int most = optin - (int)fa.sharedSizeBytes;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e) return (int)e;
  out[0] = sms, out[1] = most, out[2] = 0;
  if (shared_bytes >= 0 && shared_bytes <= most) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, kernel, kThreads,
                                                      (size_t)shared_bytes);
  }
  return (int)e;
}

template <typename T, typename P>
int launch_cgcg_window(const P* planes, const T* r, const T* w, const T* s, T* p, T* x,
                       T* r_out, T* w_out, T* s_out, T* partials, unsigned int* ticket, T* sc,
                       long long m_pad, long long B, const long long* offsets, int D, int lo,
                       int span, int nblocks, void* stream) {
  StkOffsets offs;
  int err = stk_copy_offsets(&offs, offsets, D);
  if (err) return err;
  // the geometry the kernel relies on: 4-row groups, the window inside the halos
  if (m_pad <= 0 || m_pad % kRows || B % kRows || lo % kRows || span % kRows || lo > 0 ||
      lo + span < 0 || -lo > B || lo + span > B || nblocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < D; ++k) {
    if (offs.o[k] < lo || offs.o[k] > lo + span) return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = (size_t)(span + kWindowTiles<T> * kTile) * sizeof(T);
  cgcg_window_kernel<T, P><<<nblocks, kThreads, bytes, (cudaStream_t)stream>>>(
      planes, r, w, s, p, x, r_out, w_out, s_out, partials, ticket, sc, m_pad, B, offs, D, lo,
      span);
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

// the one-pass entry points by (vector, plane) type: stk_cgcg_{wide,window}_<suffix>
#define STK_CGCG_ENTRIES(T, P, SUFFIX)                                                         \
  int stk_cgcg_wide_##SUFFIX(const P* planes, const T* r, const T* w, const T* s, T* p, T* x,   \
                             T* r_out, T* w_out, T* s_out, T* partials, unsigned int* ticket, \
                             T* sc, long long m_pad, long long B, const long long* offsets,   \
                             int D, int nblocks, void* stream) {                              \
    return launch_cgcg_wide<T, P>(planes, r, w, s, p, x, r_out, w_out, s_out, partials,       \
                                  ticket, sc, m_pad, B, offsets, D, nblocks, stream);         \
  }                                                                                           \
  int stk_cgcg_window_##SUFFIX(const P* planes, const T* r, const T* w, const T* s, T* p,     \
                               T* x, T* r_out, T* w_out, T* s_out, T* partials,               \
                               unsigned int* ticket, T* sc, long long m_pad, long long B,     \
                               const long long* offsets, int D, int lo, int span,             \
                               int nblocks, void* stream) {                                   \
    return launch_cgcg_window<T, P>(planes, r, w, s, p, x, r_out, w_out, s_out, partials,     \
                                    ticket, sc, m_pad, B, offsets, D, lo, span, nblocks,      \
                                    stream);                                                  \
  }                                                                                           \
  int stk_cgcg_window_limits_##SUFFIX(long long shared_bytes, int* out) {                     \
    return window_limits<T, P>(shared_bytes, out);                                            \
  }

STK_CGCG_ENTRIES(float, float, f32)
STK_CGCG_ENTRIES(float, __nv_bfloat16, f32_bf16)
STK_CGCG_ENTRIES(double, double, f64)

const char* stk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
