// DIA SpMV for Hopper (sm_90a).
//
// Replaces sparse_tpu/kernels/dia_spmv.py::dia_spmv_packed (pallas_call at
// :207). Computes, for every padded row i in [0, m_pad),
//
//     y[i] = sum_k planes[k * m_pad + i] * xpad[B + o_k + i]
//
// from the row-indexed plane buffer built by dia_pack (planes[k, i] is the
// coefficient of diagonal k at ROW i, zero outside the matrix) and x padded
// with B zeros on each side (dia_pad_x).
//
// What bounds it: memory. Per row it reads D plane values and writes one y;
// x is read D times at shifted positions, but neighbouring rows share those
// cache lines, so from device memory x arrives about once. At 6000^2
// (m = 36e6, D = 5, f32) that is about 4 * (D + 2) * m = 1.0 GB per call.
//
// Design: one thread per output row. Consecutive threads take consecutive
// rows, so each plane read and the y write are fully coalesced, and x goes
// through the read-only data cache (__ldg), where the D shifted windows of a
// block overlap. The TPU kernel's VMEM windows and double-buffered DMAs have
// no counterpart here: L1/L2 do the windowing. The sum runs over k in order
// with explicitly rounded operations, matching the plain torch version.

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

const char* stk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
