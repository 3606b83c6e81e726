// Spike propagation: each neuron's signed count of spiking presynaptic
// partners, in one pass over the edge tables.  Replaces no TPU kernel (the
// JAX package's synaptic_input is a plain segment_sum); design and bound:
// see src/repro_torch/kernels/synaptic_input.py.
//
// Two kernels on the caller's stream: `pack_spikes` folds the (R, n) spike
// bytes into one bit a neuron, then `propagate` walks the R x E slots in
// table order.  A block loads the bits of the table it is in into shared
// memory (n/8 bytes: 128 KB at n = 2^20), so the test of a slot's source is
// a shared-memory read.  A thread takes groups of 16 consecutive slots, two
// groups a round: one 16-byte load of a group's flags, and only where a flag
// is set the 16-byte loads of its `src`; only a spiking source reads `dst` and adds +-1 into `out`
// with an atomic whose value is unused (a RED).  Every term is +-1, so the
// float32 sums are exact in any order below 2^24.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 256;
constexpr int kThreads = 1024;                  // one block an SM at n = 2^20
constexpr int kGroup = 16;                      // slots of one 16-byte flag load
constexpr int kGroupsPerThread = 2;             // a round's groups, loaded together
// Slots of one work item: a block's share of one table at a time.
constexpr long long kChunk = (long long)kGroup * kThreads * kGroupsPerThread;

// One lane a neuron, rows padded to whole words: bit i of word w of row r
// is spiked[r][32 w + i].
__global__ void pack_spikes(const unsigned char* __restrict__ spiked,
                            unsigned int* __restrict__ bits, int n, int words,
                            long long lanes) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= lanes) return;                       // lanes is whole warps
  long long per_row = (long long)words * 32;
  long long row = t / per_row;
  int i = (int)(t - row * per_row);
  bool s = i < n && spiked[row * n + i] != 0;
  unsigned int word = __ballot_sync(0xffffffffu, s);
  if ((threadIdx.x & 31) == 0) bits[row * words + i / 32] = word;
}

struct Tables {
  const int* src;
  const int* dst;
  const unsigned char* valid;
  const float* sign;                            // null: every source +1
  float* out;
};

__device__ __forceinline__ bool fires(const unsigned int* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ void add(const Tables& t, long long base, long long slot,
                                    int i) {
  float v = t.sign ? __ldg(t.sign + base + i) : 1.0f;
  atomicAdd(t.out + base + __ldcs(t.dst + slot), v);
}

// One slot, for the ragged ends of a work item.
__device__ __forceinline__ void visit(const Tables& t, const unsigned int* bits,
                                      long long base, long long slot) {
  if (!t.valid[slot]) return;
  int i = __ldcs(t.src + slot);
  if (fires(bits, i)) add(t, base, slot, i);
}

// Sixteen slots, their flags and ids already loaded.
__device__ __forceinline__ void visit16(const Tables& t, const unsigned int* bits,
                                        long long base, long long slot, const uint4& f,
                                        const int4 (&v)[4]) {
  const unsigned int flags[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ids[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (((flags[q] >> (8 * j)) & 0xffu) && fires(bits, ids[j]))
        add(t, base, slot + 4 * q + j, ids[j]);
    }
  }
}

__device__ __forceinline__ bool has_live(const uint4& f) { return f.x | f.y | f.z | f.w; }

// Work item = (table row, chunk of kChunk slots of that row), handed out
// round robin in table order.  kShared: the row's bits live in shared
// memory; otherwise (n beyond what a block may hold) they are read from
// the packed array in device memory.  vec: the flags and `src` share their
// 16-byte alignment, so the aligned groups take vector loads.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
    propagate(Tables t, const unsigned int* __restrict__ bits, long long rows,
              long long e, int n, int words, long long chunks_per_row, int vec) {
  extern __shared__ unsigned int row_bits[];
  const long long items = rows * chunks_per_row;
  long long loaded = -1;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long row = item / chunks_per_row;
    const long long chunk = item - row * chunks_per_row;
    const unsigned int* b = bits + row * words;
    if (kShared) {
      if (row != loaded) {                      // uniform across the block
        __syncthreads();
        for (int w = threadIdx.x; w < words; w += blockDim.x) row_bits[w] = __ldg(b + w);
        __syncthreads();
        loaded = row;
      }
      b = row_bits;
    }
    const long long base = row * n;
    const long long lo = row * e + chunk * kChunk;
    const long long hi = min(lo + kChunk, (row + 1) * e);
    long long a = hi;
    if (vec) {
      const unsigned int mis = (unsigned int)(reinterpret_cast<uintptr_t>(t.valid + lo) & 15u);
      a = min(lo + (long long)((16u - mis) & 15u), hi);
    }
    const long long groups = (hi - a) / kGroup;
    const long long z = a + groups * kGroup;
    for (long long s = lo + threadIdx.x; s < a; s += blockDim.x) visit(t, b, base, s);
    for (long long s = z + threadIdx.x; s < hi; s += blockDim.x) visit(t, b, base, s);
    // Every load of a round first (the flags, then the ids of the groups
    // with a live slot), so that they are in flight together; then the
    // slots behind them.
    for (long long g0 = 0; g0 < groups; g0 += (long long)kGroupsPerThread * blockDim.x) {
      uint4 f[kGroupsPerThread];
      int4 v[kGroupsPerThread][4];
#pragma unroll
      for (int u = 0; u < kGroupsPerThread; ++u) {
        const long long g = g0 + threadIdx.x + (long long)u * blockDim.x;
        f[u] = g < groups ? __ldcs(reinterpret_cast<const uint4*>(t.valid + a) + g)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kGroupsPerThread; ++u) {
        const long long g = g0 + threadIdx.x + (long long)u * blockDim.x;
        const int4* s4 = reinterpret_cast<const int4*>(t.src + a) + 4 * g;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[u][q] = has_live(f[u]) ? __ldcs(s4 + q) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kGroupsPerThread; ++u) {
        if (has_live(f[u])) {
          const long long g = g0 + threadIdx.x + (long long)u * blockDim.x;
          visit16(t, b, base, a + g * kGroup, f[u], v[u]);
        }
      }
    }
  }
}

template <bool kShared>
cudaError_t launch_propagate(const Tables& t, const unsigned int* bits, long long rows,
                             long long e, int n, int words, int vec, size_t smem,
                             cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(propagate<kShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, propagate<kShared>,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long chunks_per_row = (e + kChunk - 1) / kChunk;
  const long long items = rows * chunks_per_row;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(items < full ? items : full);
  propagate<kShared><<<grid, kThreads, smem, stream>>>(t, bits, rows, e, n, words,
                                                       chunks_per_row, vec);
  return cudaGetLastError();
}

}  // namespace

// src, dst: int32 and valid: bool, each rows x e slots; spiked: bool and
// sign: float32 (or null: all +1), each rows x n; bits: rows x ceil(n/32)
// words of scratch; out: float32 rows x n, zeroed by the caller.  rows,
// e and n are positive.
extern "C" int synaptic_input_launch(const void* src, const void* dst, const void* valid,
                                     const void* spiked, const void* sign, void* bits,
                                     void* out, long long rows, long long e, int n,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (n + 31) / 32;
  const long long lanes = rows * words * 32LL;
  unsigned int* packed = static_cast<unsigned int*>(bits);
  pack_spikes<<<(unsigned int)((lanes + kPackThreads - 1) / kPackThreads), kPackThreads, 0,
                st>>>(static_cast<const unsigned char*>(spiked), packed, n, words, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tables t{static_cast<const int*>(src), static_cast<const int*>(dst),
                 static_cast<const unsigned char*>(valid), static_cast<const float*>(sign),
                 static_cast<float*>(out)};
  // The aligned groups' flags and ids line up only if src - 4 valid is a
  // multiple of 16 bytes; otherwise every slot takes the scalar path.
  const int vec = ((reinterpret_cast<uintptr_t>(src) - 4 * reinterpret_cast<uintptr_t>(valid))
                   & 15u) == 0;
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)words * sizeof(unsigned int);
  err = smem <= (size_t)optin
            ? launch_propagate<true>(t, packed, rows, e, n, words, vec, smem, st)
            : launch_propagate<false>(t, packed, rows, e, n, words, vec, 0, st);
  return static_cast<int>(err);
}
