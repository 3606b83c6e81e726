// Separable M2L series per (source box, target box) pair (replaces the Pallas
// TPU kernel src/repro/kernels/m2l_pair.py::m2l_separable).  Design and
// bound: see src/repro_torch/kernels/m2l_pair.py.
//
//   series = sum_{alpha,beta} sign_alpha A_alpha (M_beta / beta!)
//            * prod_d H_{alpha_d + beta_d}(y_d)
//
// One pair per thread.  A block stages its 64 pairs' moment and coefficient
// rows through shared memory with coalesced 16-byte loads (rows padded to 65
// floats so that the per-thread row reads hit distinct banks); each thread
// then keeps its 4x4x4 moment tensor in registers, builds H_0..H_6 of each
// dimension by recurrence and applies three unrolled mode products with the
// 4x4 Hankel matrices G_d[a][b] = H_{a+b}(y_d).  The 1/beta! and sign tables
// are folded in here from compile-time constants.  Built with --fmad=false:
// every product is rounded before its sum, in the JAX kernel's order.
#include <cuda_runtime.h>

namespace {

constexpr int P = 4;
constexpr int K = P * P * P;
constexpr int BIG = 2 * P - 1;
constexpr int TPB = 64;
constexpr int LD = K + 1;

__host__ __device__ constexpr float fact1(int n) {
  return n <= 1 ? 1.0f : static_cast<float>(n) * fact1(n - 1);
}

__host__ __device__ constexpr float multi_fact(int j) {
  return fact1(j / (P * P)) * fact1((j / P) % P) * fact1(j % P);
}

__host__ __device__ constexpr float sign_of(int j) {
  return ((j / (P * P) + (j / P) % P + j % P) % 2 == 0) ? 1.0f : -1.0f;
}

// Contract the index of stride STRIDE (16, 4, 1: dims 0, 1, 2 of the
// row-major (4, 4, 4) tensor) with G[a][b] = hd[a + b], in place.
template <int STRIDE>
__device__ __forceinline__ void mode_product(float (&t)[K],
                                             const float (&hd)[BIG]) {
#pragma unroll
  for (int f = 0; f < K / P; ++f) {
    const int base = (f / STRIDE) * (STRIDE * P) + (f % STRIDE);
    float old[P];
#pragma unroll
    for (int b = 0; b < P; ++b) old[b] = t[base + b * STRIDE];
#pragma unroll
    for (int a = 0; a < P; ++a) {
      float acc = hd[a] * old[0];
#pragma unroll
      for (int b = 1; b < P; ++b) acc = acc + hd[a + b] * old[b];
      t[base + a * STRIDE] = acc;
    }
  }
}

__global__ void __launch_bounds__(TPB)
    m2l_separable_kernel(const float* __restrict__ moms,
                         const float* __restrict__ herm,
                         const float* __restrict__ y, float* __restrict__ out,
                         int b) {
  __shared__ float s_moms[TPB * LD];
  __shared__ float s_herm[TPB * LD];
  const int base = blockIdx.x * TPB;
  const int rows = min(TPB, b - base);
  const float4* m4 = reinterpret_cast<const float4*>(moms) +
                     static_cast<size_t>(base) * (K / 4);
  const float4* h4 = reinterpret_cast<const float4*>(herm) +
                     static_cast<size_t>(base) * (K / 4);
  for (int q = threadIdx.x; q < rows * (K / 4); q += TPB) {
    const int r = q / (K / 4);
    const int c = (q % (K / 4)) * 4;
    const float4 mv = __ldg(m4 + q);
    const float4 hv = __ldg(h4 + q);
    float* sm = s_moms + r * LD + c;
    float* sh = s_herm + r * LD + c;
    sm[0] = mv.x; sm[1] = mv.y; sm[2] = mv.z; sm[3] = mv.w;
    sh[0] = hv.x; sh[1] = hv.y; sh[2] = hv.z; sh[3] = hv.w;
  }
  __syncthreads();
  const int row = threadIdx.x;
  if (row >= rows) return;
  const size_t i = static_cast<size_t>(base) + row;

  // Per-dimension Hermite polynomials H_0..H_{2p-2}(y_d).
  float h[3][BIG];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float two_y = 2.0f * __ldg(y + 3 * i + d);
    h[d][0] = 1.0f;
    h[d][1] = two_y;
#pragma unroll
    for (int n = 1; n < BIG - 1; ++n)
      h[d][n + 1] = two_y * h[d][n] - (2.0f * n) * h[d][n - 1];
  }

  float t[K];
  const float* my_m = s_moms + row * LD;
#pragma unroll
  for (int j = 0; j < K; ++j) t[j] = my_m[j] / multi_fact(j);

  mode_product<P * P>(t, h[0]);
  mode_product<P>(t, h[1]);
  mode_product<1>(t, h[2]);

  const float* my_h = s_herm + row * LD;
  float acc = (my_h[0] * sign_of(0)) * t[0];
#pragma unroll
  for (int j = 1; j < K; ++j) acc = acc + (my_h[j] * sign_of(j)) * t[j];
  out[i] = acc;
}

}  // namespace

extern "C" int m2l_separable_launch(const void* moms, const void* herm,
                                    const void* y, void* out, int b,
                                    void* stream) {
  const int blocks = (b + TPB - 1) / TPB;
  m2l_separable_kernel<<<blocks, TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(moms), static_cast<const float*>(herm),
      static_cast<const float*>(y), static_cast<float*>(out), b);
  return static_cast<int>(cudaGetLastError());
}
