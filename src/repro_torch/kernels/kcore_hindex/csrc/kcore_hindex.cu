// Rowwise clipped h-index over degree-bucketed ELL tiles, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/kcore_hindex/kernel.py:_hindex_kernel (through
// hindex_rows_pallas and ops.hindex_rows). For each row u of nbr_est (R, W)
// with its own estimate est_u[u], the result is found by the binary search the
// TPU kernel runs:
//     vals = min(nbr_est[u, :], est_u[u]);  lo = 0;  hi = est_u[u]
//     n_iters times:  mid = (lo + hi + 1) / 2;  k = max(mid, 1)
//                     if count(vals >= k) >= mid: lo = mid  else: hi = mid - 1
//     out[u] = lo
// For est_u >= 0 (estimates are degrees and only fall), lo <= hi always holds
// and lo == hi is a fixpoint of a probe, so stopping once lo == hi gives the
// same answer as running all n_iters probes. With too few probes the answer
// is the same partial one the reference gives.
//
// What bounds it: bytes. Each slot of the tile is read once from HBM and one
// int32 is written per row: 4RW + 8R bytes against 3.35 TB/s. A probe is a
// compare and a count, about log2(W) + 1 of them per row.
//
// Design, by width:
//   W <= 8      one thread per row; the row sits in registers.
//   W <= 2048   one warp per row; the row is read once, coalesced, into
//               shared memory (at most 8 KB per warp), and each probe counts
//               32 slots at a time with __popc(__ballot_sync(...)), which
//               leaves the count in every lane.
//   W > 2048    one block of 512 threads per row (the widest bucket, W up to
//               ~98K at soc-pokec scale: 384 KB, more than shared memory
//               holds). Each probe re-reads the row, from L2 after the first,
//               and reduces the count with __reduce_add_sync and a double-
//               buffered shared array, so one __syncthreads per probe.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreadRowMax = 8;
constexpr int kWarpRowMax = 2048;
constexpr int kThreadRowsPerBlock = 256;
constexpr int kWarpsPerBlock = 4;
constexpr int kBlockThreads = 512;

__global__ void __launch_bounds__(kThreadRowsPerBlock)
hindex_thread_rows(const int* __restrict__ nbr, const int* __restrict__ est_u,
                   int* __restrict__ out, long long rows, int width, int n_iters) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int eu = est_u[r];
  const int* row = nbr + r * width;
  int v[kThreadRowMax];
#pragma unroll
  for (int j = 0; j < kThreadRowMax; ++j) v[j] = j < width ? min(row[j], eu) : 0;
  int lo = 0, hi = eu;
  for (int it = 0; it < n_iters && lo < hi; ++it) {
    const int mid = (lo + hi + 1) >> 1;
    const int k = max(mid, 1);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kThreadRowMax; ++j) cnt += v[j] >= k;  // padding is 0 < k
    if (cnt >= mid) lo = mid; else hi = mid - 1;
  }
  out[r] = lo;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hindex_warp_rows(const int* __restrict__ nbr, const int* __restrict__ est_u,
                 int* __restrict__ out, long long rows, int width, int n_iters) {
  extern __shared__ int tile[];  // kWarpsPerBlock rows of `width` values
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = blockIdx.x * (long long)kWarpsPerBlock + warp;
  if (r >= rows) return;  // uniform across the warp; no block-wide barrier below
  int* s = tile + warp * width;
  const int eu = est_u[r];
  const int* row = nbr + r * width;
  for (int j = lane; j < width; j += 32) s[j] = min(row[j], eu);
  __syncwarp();
  int lo = 0, hi = eu;
  for (int it = 0; it < n_iters && lo < hi; ++it) {
    const int mid = (lo + hi + 1) >> 1;
    const int k = max(mid, 1);
    int cnt = 0;
    for (int c = 0; c < width; c += 32) {
      const int j = c + lane;
      cnt += __popc(__ballot_sync(kFull, j < width && s[j] >= k));
    }
    if (cnt >= mid) lo = mid; else hi = mid - 1;
  }
  if (lane == 0) out[r] = lo;
}

__global__ void __launch_bounds__(kBlockThreads)
hindex_block_rows(const int* __restrict__ nbr, const int* __restrict__ est_u,
                  int* __restrict__ out, int width, int n_iters) {
  __shared__ unsigned partial[2][kBlockThreads / 32];
  const long long r = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int eu = est_u[r];
  const int* row = nbr + r * (long long)width;
  int lo = 0, hi = eu;
  int buf = 0;
  for (int it = 0; it < n_iters && lo < hi; ++it) {  // lo, hi are block-uniform
    const int mid = (lo + hi + 1) >> 1;
    const int k = max(mid, 1);
    unsigned cnt = 0;
    for (int j = threadIdx.x; j < width; j += kBlockThreads) cnt += min(row[j], eu) >= k;
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0) partial[buf][warp] = cnt;
    __syncthreads();
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < kBlockThreads / 32; ++w) total += partial[buf][w];
    buf ^= 1;  // the next probe writes the other half: no second barrier
    if ((long long)total >= mid) lo = mid; else hi = mid - 1;
  }
  if (threadIdx.x == 0) out[r] = lo;
}

}  // namespace

extern "C" {

// nbr_est (rows, width) int32 row-major, est_u (rows,) int32 >= 0,
// out (rows,) int32. Launches on `stream`; returns cudaGetLastError().
int kcore_hindex_i32(const void* nbr_est, const void* est_u, void* out, long long rows,
                     long long width, int n_iters, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* nbr = (const int*)nbr_est;
  const int* eu = (const int*)est_u;
  int* o = (int*)out;
  if (width <= kThreadRowMax) {
    const long long blocks = (rows + kThreadRowsPerBlock - 1) / kThreadRowsPerBlock;
    hindex_thread_rows<<<(unsigned)blocks, kThreadRowsPerBlock, 0, s>>>(
        nbr, eu, o, rows, (int)width, n_iters);
  } else if (width <= kWarpRowMax) {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const size_t smem = (size_t)kWarpsPerBlock * width * sizeof(int);
    hindex_warp_rows<<<(unsigned)blocks, kWarpsPerBlock * 32, smem, s>>>(
        nbr, eu, o, rows, (int)width, n_iters);
  } else {
    hindex_block_rows<<<(unsigned)rows, kBlockThreads, 0, s>>>(nbr, eu, o, (int)width, n_iters);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
