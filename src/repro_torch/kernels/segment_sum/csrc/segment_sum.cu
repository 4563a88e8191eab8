// Segment sum of int32 values over CSR rows, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segment_sum/kernel.py:_seg_kernel (through
// segment_sum_pallas and ops.segment_sum_blocked). On the TPU that kernel is a
// one-hot (be, R) matmul on the MXU per padded edge block, because the TPU has
// no fast scatter. On the k-core path the values are int32, one per arc, and
// the arcs are sorted by source, so on Hopper the same function is a plain CSR
// row reduction: out[r] = sum(vals[row_ptr[r] : row_ptr[r+1]]).
//
// What bounds it: bytes. Each value is read once and each row pointer once,
// and one int32 is written per row: 4E + 8(n+1) + 4n bytes, against 3.35 TB/s
// of HBM. There is no arithmetic to speak of.
//
// Design: a warp takes 32 consecutive rows. Rows of degree <= 8 (most rows of
// a power-law graph) are summed by their own lane, thread per row. The other
// rows of the 32 are then summed one at a time by the whole warp: strided,
// coalesced reads and one __reduce_add_sync. Empty rows come out 0, since the
// lane that owns one writes its (empty) sum. Sums are taken in uint32, so
// overflow wraps exactly as int32 addition does in the reference.

#include <cuda_runtime.h>

namespace {

constexpr int kSmallRow = 8;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
segment_sum_rows(const int* __restrict__ vals, const long long* __restrict__ row_ptr,
                 int* __restrict__ out, long long n) {
  const int lane = threadIdx.x & 31;
  const long long base = ((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5) * 32;
  if (base >= n) return;  // uniform across the warp

  const long long r = base + lane;
  long long s = 0, e = 0;
  if (r < n) {
    s = row_ptr[r];
    e = row_ptr[r + 1];
  }
  const bool small = r < n && e - s <= kSmallRow;
  if (small) {
    unsigned acc = 0;
    for (long long i = s; i < e; ++i) acc += (unsigned)vals[i];
    out[r] = (int)acc;
  }

  unsigned big = __ballot_sync(kFull, r < n && !small);
  while (big) {
    const int j = __ffs(big) - 1;
    big &= big - 1;
    const long long bs = __shfl_sync(kFull, s, j);
    const long long be = __shfl_sync(kFull, e, j);
    unsigned acc = 0;
    for (long long i = bs + lane; i < be; i += 32) acc += (unsigned)vals[i];
    acc = __reduce_add_sync(kFull, acc);
    if (lane == 0) out[base + j] = (int)acc;
  }
}

}  // namespace

extern "C" {

// vals (E,) int32 in row order, row_ptr (n+1,) int64 with row_ptr[n] == E,
// out (n,) int32. Launches on `stream`; returns cudaGetLastError().
int segment_sum_i32(const void* vals, const void* row_ptr, void* out, long long n,
                    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long warps = (n + 31) / 32;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  segment_sum_rows<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)vals, (const long long*)row_ptr, (int*)out, n);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
