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
// Every negative index is padding and adds nothing (the TPU kernel adds 0.0
// for it, which leaves a float32 sum unchanged). Sums are float32 in j order;
// the output is written in the table's dtype (float32 or bf16, rounded to
// nearest even). L = 0 gives zeros.
//
// What bounds it: bytes. Each index is read once and each output element
// written once; the table rows a batch touches are read at least once
// (DIN's 10,000 x 18 category table is 0.72 MB and stays in L2). There is one
// add per gathered element and nothing else.
//
// Design: one thread per output element (b, d), threads in (b, d) order, in a
// grid-stride loop. A warp covers 32 consecutive elements, so with D = 18 it
// spans parts of two or three bags: the threads of one bag read the same index
// (one broadcast load) and then one contiguous D-element row. Rows are read
// element by element, because a row of D = 18 float32 is 72 bytes, 8-byte but
// not 16-byte aligned, so vector loads of rows would be wrong. Row offsets are
// 64-bit. A padding index reads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_sum(const T* __restrict__ table, const int* __restrict__ idx, T* __restrict__ out,
        long long n_out, int L, int D) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n_out; t += stride) {
    const long long b = t / D;
    const int d = (int)(t - b * D);
    const int* row = idx + b * L;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) {
      const int ix = __ldg(row + j);
      if (ix >= 0) acc += to_f32(table[(long long)ix * D + d]);
    }
    out[t] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* table, const void* idx, void* out, long long B, int L, int D,
           cudaStream_t stream) {
  const long long n_out = B * D;
  long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // the grid-stride loop covers the rest
  bag_sum<T><<<(unsigned)blocks, kThreads, 0, stream>>>((const T*)table, (const int*)idx,
                                                         (T*)out, n_out, L, D);
  return (int)cudaGetLastError();
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
