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
// of HBM. There is no arithmetic to speak of. What keeps a mapping of rows
// to threads or warps far from that bound is the degree skew: a power-law
// graph's widest row, walked by one warp, leaves the rest of the card idle.
//
// Design: the merge path of Merrill & Garland (SC 2016). The n row ends and
// the E arcs are merged into one path of n + E items (row r's end comes after
// its last arc), and every block takes kItems consecutive items of it, so a
// block does the same work whatever the rows' lengths: a 98,432-arc row is
// spread over 25 blocks, and a million empty rows cost a million items. A
// first small kernel finds where every block's stretch starts, one warp a
// boundary with a 32-ary search of row_ptr, so that the blocks of the main
// kernel start on their loads rather than on a chain of dependent searches.
// A block reads its row ends into shared memory and, after them in the same
// buffer (18.5 KB a block, 32 registers a thread: 8 blocks an SM), its arcs
// with 16-byte loads from the aligned chunks that hold them
// (neighbouring threads on neighbouring chunks; the unaligned head and tail
// of the stretch element by element, so a view that starts 4 bytes off a
// 16-byte boundary, or any E, is read as it is). Each thread then walks
// kItemsPerThread items of the path from shared memory (found by a binary
// search there): an arc adds to the running sum, a row end stores it. The
// first row a thread ends may have begun in threads before it: their partial
// sums come from a segmented scan over the block, and the thread stores that
// row after it. The row a block ends in, which goes on in later blocks, is
// left as a carry (row, partial sum) in a scratch array, and a last small
// kernel adds the carries into the output with atomicAdd. Integer addition
// mod 2^32 does not depend on order, so the atomics keep the result
// bit-exact; a carry pass after the stores, and not a zeroed output, means
// the output is written once and no memset is needed. Empty rows are path
// items like any other and come out 0. Sums are taken in uint32, so overflow
// wraps exactly as int32 addition does in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 16;
constexpr int kItems = kThreads * kItemsPerThread;  // path items (row ends + arcs) a block
constexpr unsigned kFull = 0xffffffffu;

// A block's row ends and then its arcs share one buffer in shared memory
// (ni + nj <= kItems words), the arcs with one padding word every 16, so that
// the threads' runs of kItemsPerThread = 16 values fall on different banks.
__device__ __forceinline__ int padded(int q) { return q + (q >> 4); }
constexpr int kBufWords = kItems + 8 + (kItems + 8) / 16 + 1;

// Rows consumed in the first d items of the path: the least i in
// [max(d - E, 0), min(d, n)] with row_ptr[i + 1] + i >= d. One warp, 32
// probes a step; the probes below the answer are a prefix of the lanes.
__device__ long long path_search_rows(const long long* __restrict__ row_ptr, long long n,
                                      long long E, long long d, int lane) {
  long long lo = d > E ? d - E : 0;
  long long hi = d < n ? d : n;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool below = p < hi && __ldg(row_ptr + p + 1) + p < d;
    const int nb = __popc(__ballot_sync(kFull, below));
    if (nb == 0) {
      hi = lo;
    } else {
      const long long last = lo + (nb - 1) * step;
      hi = last + step < hi ? last + step : hi;
      lo = last + 1;
    }
  }
  return lo;
}

// The same search in the block's frame: ends[k] is row k's end relative to
// the block's first arc, ni rows and nj arcs.
__device__ __forceinline__ int path_search_block(const int* ends, int ni, int nj, int d) {
  int lo = d > nj ? d - nj : 0;
  int hi = d < ni ? d : ni;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] + mid < d) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Where every block's stretch of the path starts: coords[2b], coords[2b + 1]
// = the rows and arcs consumed in the first b * kItems items, for b in
// [0, blocks]. One warp a boundary, so the merge-path blocks start on their
// loads instead of on a chain of dependent searches.
__global__ void __launch_bounds__(kThreads)
segment_sum_path_search(const long long* __restrict__ row_ptr, long long* __restrict__ coords,
                        long long n, long long E, long long blocks) {
  const long long b = blockIdx.x * (long long)(kThreads / 32) + (threadIdx.x >> 5);
  if (b > blocks) return;  // uniform across the warp
  const long long d = b * kItems < n + E ? b * kItems : n + E;
  const long long i = path_search_rows(row_ptr, n, E, d, threadIdx.x & 31);
  if ((threadIdx.x & 31) == 0) {
    coords[2 * b] = i;
    coords[2 * b + 1] = d - i;
  }
}

// 8 blocks of 256 threads an SM: 32 registers a thread, 20 KB of shared memory a block
__global__ void __launch_bounds__(kThreads, 8)
segment_sum_merge_path(const int* __restrict__ vals, const long long* __restrict__ row_ptr,
                       const long long* __restrict__ coords, int* __restrict__ out,
                       long long* __restrict__ carries) {
  __shared__ int s_buf[kBufWords];  // row ends [0, ni), then the arcs
  __shared__ unsigned s_scan[kThreads];
  __shared__ unsigned s_warp_val[kThreads / 32];
  __shared__ int s_warp_flag[kThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i0 = __ldg(coords + 2 * blockIdx.x), j0 = __ldg(coords + 2 * blockIdx.x + 1);
  const int ni = (int)(__ldg(coords + 2 * blockIdx.x + 2) - i0);
  const int nj = (int)(__ldg(coords + 2 * blockIdx.x + 3) - j0);
  int* s_ends = s_buf;
  int* s_vals = s_buf + ni;

  // row ends, relative to j0: every row the block ends, ends inside its arcs
  for (int k = tid; k < ni; k += kThreads) s_ends[k] = (int)(__ldg(row_ptr + i0 + 1 + k) - j0);
  // arcs: 16-byte loads of the aligned chunks, the partial chunks at either end by element
  const int head = (int)(((uintptr_t)(vals + j0) >> 2) & 3);
  const int* base = vals + j0 - head;
  const int span = head + nj;
  for (int q = tid * 4; q < span; q += kThreads * 4) {
    if (q >= head && q + 4 <= span) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(base + q));
      const int p = padded(q);  // q % 16 <= 12: the four words stay together
      s_vals[p] = v.x;
      s_vals[p + 1] = v.y;
      s_vals[p + 2] = v.z;
      s_vals[p + 3] = v.w;
    } else {
      for (int e = 0; e < 4; ++e)
        if (q + e >= head && q + e < span) s_vals[padded(q + e)] = __ldg(base + q + e);
    }
  }
  __syncthreads();

  // this thread's stretch of the path
  const int total = ni + nj;
  const int dt = min(tid * kItemsPerThread, total);
  const int dt_end = min(dt + kItemsPerThread, total);
  const int first = path_search_block(s_ends, ni, nj, dt);
  int i = first, j = dt - first;
  unsigned acc = 0, head_sum = 0;
  bool ended = false;  // this thread ended a row: the row it started in
#pragma unroll 4
  for (int k = dt; k < dt_end; ++k) {
    if (i < ni && s_ends[i] <= j) {
      if (ended) out[i0 + i] = (int)acc;
      else head_sum = acc;
      ended = true;
      acc = 0;
      ++i;
    } else {
      acc += (unsigned)s_vals[padded(head + j)];
      ++j;
    }
  }

  // segmented inclusive scan of the tails: S(t) = acc(t) + (ended(t) ? 0 : S(t - 1))
  unsigned v = acc;
  int f = ended;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned pv = __shfl_up_sync(kFull, v, o);
    const int pf = __shfl_up_sync(kFull, f, o);
    if (lane >= o) {
      if (!f) v += pv;
      f |= pf;
    }
  }
  if (lane == 31) {
    s_warp_val[warp] = v;
    s_warp_flag[warp] = f;
  }
  __syncthreads();
  if (!f) {
    unsigned pre = 0;
    for (int w = 0; w < warp; ++w) pre = s_warp_flag[w] ? s_warp_val[w] : pre + s_warp_val[w];
    v += pre;
  }
  s_scan[tid] = v;
  __syncthreads();
  if (ended) out[i0 + first] = (int)(head_sum + (tid > 0 ? s_scan[tid - 1] : 0u));
  if (tid == kThreads - 1) {  // i == ni: the row the block ends in
    carries[2 * blockIdx.x] = i0 + i;
    carries[2 * blockIdx.x + 1] = (long long)v;
  }
}

// Adds each block's carry into the row it belongs to (after every store of
// segment_sum_merge_path, which precedes it on the stream).
__global__ void __launch_bounds__(kThreads)
segment_sum_carries(const long long* __restrict__ carries, int* __restrict__ out, long long n,
                    long long blocks) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= blocks) return;
  const long long r = carries[2 * b];
  const unsigned v = (unsigned)carries[2 * b + 1];
  if (v != 0 && r < n) atomicAdd(reinterpret_cast<unsigned*>(out) + r, v);
}

}  // namespace

extern "C" {

// vals (E,) int32 in row order, row_ptr (n+1,) int64 with row_ptr[n] == E,
// out (n,) int32, scratch 4 * blocks + 2 int64 for blocks = ceil((n + E) /
// kItems): the blocks' path coordinates, then their carries; items_per_block
// must equal kItems. Launches the three kernels on `stream`;
// returns cudaGetLastError().
int segment_sum_i32(const void* vals, const void* row_ptr, void* out, void* scratch, long long n,
                    long long E, long long items_per_block, void* stream) {
  if (items_per_block != kItems || n < 0 || E < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n + E + kItems - 1) / kItems;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long* coords = (long long*)scratch;     // (blocks + 1, 2)
  long long* carries = coords + 2 * (blocks + 1);  // (blocks, 2)
  constexpr int kWarps = kThreads / 32;
  segment_sum_path_search<<<(unsigned)((blocks + kWarps) / kWarps), kThreads, 0, s>>>(
      (const long long*)row_ptr, coords, n, E, blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_sum_merge_path<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int*)vals, (const long long*)row_ptr, coords, (int*)out, carries);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_sum_carries<<<(unsigned)((blocks + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      carries, (int*)out, n, blocks);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
