// DIA SpMV for Hopper (sm_90a): two kernels.
//
// Packed kernel (dia_spmv_packed). Replaces
// sparse_tpu/kernels/dia_spmv.py::dia_spmv_packed (pallas_call at :207).
// Computes, for every padded row i in [0, m_pad),
//
//     y[i] = sum_k planes[k * m_pad + i] * xpad[B + o_k + i]
//
// from the row-indexed plane buffer built by dia_pack (planes[k, i] is the
// coefficient of diagonal k at ROW i, zero outside the matrix) and x padded
// with B zeros on each side (dia_pad_x).
//
// Direct kernel (dia_spmv_direct). Replaces
// sparse_tpu/kernels/dia_spmv.py::_dia_spmv_pallas (pallas_call at :639),
// reached through dia_spmv_pallas. Computes, for every row i in [0, m),
//
//     y[i] = sum_k data[k * ld + i + o_k] * x[i + o_k]   over 0 <= i + o_k < ncol
//
// straight from the scipy column-indexed [D, ld] planes (data[k, j] holds
// A[j - o_k, j]) and the unpadded x; ncol = min(n, ld). The reference pads
// the planes to [ceil8(D), m_pad + 2B] on every call; here the planes are
// read in place and the bounds test takes the place of the padding.
//
// What bounds both: memory. Per row they read D plane values and write one
// y; x is read D times at shifted positions, but neighbouring rows share
// those cache lines, so from device memory x arrives about once. At 6000^2
// (m = 36e6, D = 5, f32) that is about 4 * (D + 2) * m = 1.0 GB per call.
//
// Design: one thread per output row. Consecutive threads take consecutive
// rows, so each plane read (at row i + o_k in the direct kernel, still
// consecutive across a warp) and the y write are fully coalesced, and x goes
// through the read-only data cache (__ldg), where the D shifted windows of a
// block overlap. The TPU kernels' VMEM windows and double-buffered DMAs have
// no counterpart here: L1/L2 do the windowing. The sum runs over k in order
// with explicitly rounded operations, matching the plain torch versions bit
// for bit; a term outside the matrix adds 0 * 0, as the plain versions'
// zero padding does.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ planes, const T* __restrict__ xpad,
                T* __restrict__ y, long long m_pad, long long B, StkOffsets offs,
                int D) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m_pad) return;
  const T* xi = xpad + B + i;
  T acc = T(0);
  for (int k = 0; k < D; ++k) {
    acc = add_rn(acc, mul_rn(planes[(long long)k * m_pad + i], __ldg(xi + offs.o[k])));
  }
  y[i] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_direct_kernel(const T* __restrict__ data, const T* __restrict__ x,
                       T* __restrict__ y, long long m, long long ncol, long long ld,
                       StkOffsets offs, int D) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  T acc = T(0);
  for (int k = 0; k < D; ++k) {
    const long long j = i + offs.o[k];
    const bool inside = j >= 0 && j < ncol;
    const T a = inside ? data[(long long)k * ld + j] : T(0);
    const T v = inside ? __ldg(x + j) : T(0);
    acc = add_rn(acc, mul_rn(a, v));
  }
  y[i] = acc;
}

template <typename T>
int launch(const T* planes, const T* xpad, T* y, long long m_pad, long long B,
           const long long* offsets, int D, void* stream) {
  StkOffsets offs;
  int err = stk_copy_offsets(&offs, offsets, D);
  if (err) return err;
  if (m_pad <= 0) return 0;
  const long long blocks = (m_pad + kThreads - 1) / kThreads;
  dia_spmv_kernel<T><<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      planes, xpad, y, m_pad, B, offs, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_direct(const T* data, const T* x, T* y, long long m, long long ncol, long long ld,
                  const long long* offsets, int D, void* stream) {
  StkOffsets offs;
  int err = stk_copy_offsets(&offs, offsets, D);
  if (err) return err;
  if (m <= 0) return 0;
  const long long blocks = (m + kThreads - 1) / kThreads;
  dia_spmv_direct_kernel<T><<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      data, x, y, m, ncol, ld, offs, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stk_dia_spmv_f32(const float* planes, const float* xpad, float* y, long long m_pad,
                     long long B, const long long* offsets, int D, void* stream) {
  return launch<float>(planes, xpad, y, m_pad, B, offsets, D, stream);
}

int stk_dia_spmv_f64(const double* planes, const double* xpad, double* y,
                     long long m_pad, long long B, const long long* offsets, int D,
                     void* stream) {
  return launch<double>(planes, xpad, y, m_pad, B, offsets, D, stream);
}

int stk_dia_spmv_direct_f32(const float* data, const float* x, float* y, long long m,
                            long long ncol, long long ld, const long long* offsets, int D,
                            void* stream) {
  return launch_direct<float>(data, x, y, m, ncol, ld, offsets, D, stream);
}

int stk_dia_spmv_direct_f64(const double* data, const double* x, double* y, long long m,
                            long long ncol, long long ld, const long long* offsets, int D,
                            void* stream) {
  return launch_direct<double>(data, x, y, m, ncol, ld, offsets, D, stream);
}

const char* stk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
