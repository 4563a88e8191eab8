// Sum-bag of embedding rows, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/embedding_bag/kernel.py:_bag_kernel (through
// embedding_bag_pallas and ops.embedding_bag_fused). On the TPU that kernel
// walks a sequential grid of 8-bag tiles, scalar-prefetches the indices and
// DMA-gathers one (1, D) table row at a time into a VMEM accumulator. Here the
// function is the same and the mapping is not:
//
//   out[b, :] = sum over j in order of table[idx[b, j], :], for idx[b, j] >= 0
//
// Every negative index is padding and reads nothing (the TPU kernel adds 0.0
// for it, which leaves a float32 sum unchanged). Sums are float32 in j order;
// the output is written in the table's dtype (float32 or bf16, rounded to
// nearest even). L = 0 gives zeros.
//
// What bounds it: bytes. Each index is read once and each output element
// written once; the table rows a batch touches are read at least once. There
// is one add per gathered element and nothing else. At DIN's widths the rows
// gathered (B x L rows of D = 18) come mostly from L2 (the 10,000 x 18
// category table is 0.72 MB), so the rate at which the SMs take rows from L2
// sets the pace before HBM does: 72-byte rows touch three 32-byte sectors
// each. Beyond that, a kernel must not re-read an index for every output
// element, nor read rows 4 bytes at a time with one dependent
// index-then-row pair in flight a thread.
//
// Design: a group of G lanes owns one bag, each lane a slice of D read as one
// vector of VB bytes (16, 8 or 4; 2 for a bf16 row of odd D): the widest that
// divides the row's bytes and the table's base address, chosen on the host,
// so a row of D = 18 float32 (72 bytes, 8-byte aligned) is 9 float2 reads by
// 9 lanes and a warp takes 3 bags. A block (8 warps) stages the indices of its
// bags, kLTile at a time, in shared memory with coalesced loads: each index is
// read from device memory once and handed to the lanes of its bag from there.
// The loop over j issues kUnroll row reads before it adds any of them, so that
// many rows are in flight per lane; the adds then go in j order. The lanes of
// a bag write its output row as one contiguous run, the bags of a warp side by
// side. Row offsets are 64-bit; a padding index reads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLTile = 32;   // indices a bag stages at a time
constexpr int kUnroll = 8;   // row reads in flight per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VB bytes of a row, read and written as one vector
template <typename T, int VB>
struct alignas(VB) Pack {
  T v[VB / sizeof(T)];
};

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
embedding_bag_sum_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                         T* __restrict__ out, long long B, int L, int D, int G, int P) {
  constexpr int kE = VB / sizeof(T);  // elements a vector
  using V = Pack<T, VB>;
  extern __shared__ int s_idx[];      // (bags of the block) x kLTile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = D / kE;               // vectors a row
  const int bags = kWarps * P;
  const long long b0 = (long long)blockIdx.x * bags;
  const int slot = warp * P + lane / G;  // this lane's bag in the block
  const long long b = b0 + slot;
  const bool active = lane / G < P && b < B;
  const int rounds = (C + G - 1) / G;    // more than one only for rows wider than 32 vectors

  for (int r = 0; r < rounds; ++r) {
    const int c = lane % G + r * G;
    const bool mine = active && c < C;
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < L; j0 += kLTile) {
      const int lt = min(kLTile, L - j0);
      __syncthreads();  // the previous tile is read
      for (int k = tid; k < bags * lt; k += kThreads) {
        const int bag = k / lt, jj = k - bag * lt;
        const long long bb = b0 + bag;
        s_idx[bag * kLTile + jj] = bb < B ? __ldg(idx + bb * L + j0 + jj) : -1;
      }
      __syncthreads();
      if (mine) {
        const int* ix_row = s_idx + slot * kLTile;
        const T* col = table + (long long)c * kE;
        for (int jj = 0; jj < lt; jj += kUnroll) {
          int ix[kUnroll];
          V v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) ix[u] = jj + u < lt ? ix_row[jj + u] : -1;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (ix[u] >= 0) v[u] = *reinterpret_cast<const V*>(col + (long long)ix[u] * D);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (ix[u] >= 0) {
#pragma unroll
              for (int e = 0; e < kE; ++e) acc[e] += to_f32(v[u].v[e]);
            }
        }
      }
    }
    if (mine) {
      V o;
#pragma unroll
      for (int e = 0; e < kE; ++e) o.v[e] = from_f32<T>(acc[e]);
      *reinterpret_cast<V*>(out + b * D + (long long)c * kE) = o;
    }
  }
}

template <typename T, int VB>
int launch_vec(const void* table, const void* idx, void* out, long long B, int L, int D,
               cudaStream_t stream) {
  constexpr int kE = VB / sizeof(T);
  const int C = D / kE;
  const int G = C < 32 ? C : 32;
  const int P = 32 / G;
  const long long bags = (long long)kWarps * P;
  const long long blocks = (B + bags - 1) / bags;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)bags * kLTile * sizeof(int);
  embedding_bag_sum_kernel<T, VB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)table, (const int*)idx, (T*)out, B, L, D, G, P);
  return (int)cudaGetLastError();
}

// The widest vector that divides both the row's bytes and the table's base.
template <typename T>
int launch(const void* table, const void* idx, void* out, long long B, int L, int D,
           cudaStream_t stream) {
  const long long row = (long long)D * sizeof(T);
  const uintptr_t base = (uintptr_t)table;
  auto fits = [&](int vb) { return row % vb == 0 && base % vb == 0; };
  if (fits(16)) return launch_vec<T, 16>(table, idx, out, B, L, D, stream);
  if (fits(8)) return launch_vec<T, 8>(table, idx, out, B, L, D, stream);
  if constexpr (sizeof(T) == 4) {
    return launch_vec<T, 4>(table, idx, out, B, L, D, stream);
  } else {
    if (fits(4)) return launch_vec<T, 4>(table, idx, out, B, L, D, stream);
    return launch_vec<T, 2>(table, idx, out, B, L, D, stream);
  }
}

}  // namespace

extern "C" {

// table (V, D) contiguous, float32 (dtype 0) or bf16 (dtype 1); idx (B, L)
// contiguous int32 with every entry < V; out (B, D) contiguous in the table's
// dtype. Launches on `stream`; returns cudaGetLastError().
int embedding_bag_sum(const void* table, const void* idx, void* out, long long B, int L, int D,
                      int dtype, void* stream) {
  if (B <= 0 || D <= 0) return (int)cudaSuccess;
  if (dtype == 0) return launch<float>(table, idx, out, B, L, D, (cudaStream_t)stream);
  if (dtype == 1) return launch<__nv_bfloat16>(table, idx, out, B, L, D, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
