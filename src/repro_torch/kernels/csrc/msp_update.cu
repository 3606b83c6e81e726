// Fused MSP phase-1 neuron update (replaces the Pallas TPU kernel
// src/repro/kernels/msp_update.py::msp_update).  Design, rounding contract
// and bound: see src/repro_torch/kernels/msp_update.py.
//
// Build with --fmad=false: the only fused multiply-adds are the explicit
// __fmaf_rn calls below, which reproduce XLA:CPU's contraction of the JAX
// reference bit for bit.
#include <cuda_runtime.h>

namespace {

__global__ void msp_update_kernel(const float* __restrict__ x,
                                  const int* __restrict__ refrac,
                                  const float* __restrict__ ca,
                                  const float* __restrict__ syn,
                                  const float* __restrict__ u,
                                  float* __restrict__ x_out,
                                  int* __restrict__ refrac_out,
                                  bool* __restrict__ spiked_out,
                                  float* __restrict__ ca_out, int n, float x0,
                                  float r, float background, float w_syn,
                                  float beta_ca, float one_minus_tau_ca,
                                  int refractory) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float xi = x[i];
  // x' = fma(w_syn, syn, fma(x0 - x, r, x) + background)
  float xn = __fmaf_rn(w_syn, syn[i], __fmaf_rn(x0 - xi, r, xi) + background);
  int ri = refrac[i];
  bool spiked = (u[i] < xn) && (ri <= 0);
  float spk = spiked ? 1.0f : 0.0f;
  x_out[i] = xn;
  refrac_out[i] = spiked ? refractory : max(ri - 1, 0);
  spiked_out[i] = spiked;
  // ca' = fma(ca, 1 - tau_ca, beta_ca * spk)
  ca_out[i] = __fmaf_rn(ca[i], one_minus_tau_ca, beta_ca * spk);
}

}  // namespace

extern "C" int msp_update_launch(const void* x, const void* refrac,
                                 const void* ca, const void* syn,
                                 const void* u, void* x_out, void* refrac_out,
                                 void* spiked_out, void* ca_out, int n,
                                 float x0, float r, float background,
                                 float w_syn, float beta_ca,
                                 float one_minus_tau_ca, int refractory,
                                 void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  msp_update_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(refrac),
      static_cast<const float*>(ca), static_cast<const float*>(syn),
      static_cast<const float*>(u), static_cast<float*>(x_out),
      static_cast<int*>(refrac_out), static_cast<bool*>(spiked_out),
      static_cast<float*>(ca_out), n, x0, r, background, w_syn, beta_ca,
      one_minus_tau_ca, refractory);
  return static_cast<int>(cudaGetLastError());
}
