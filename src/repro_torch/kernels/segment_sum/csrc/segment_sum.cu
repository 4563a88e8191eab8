// Segment sums over CSR rows, for Hopper (sm_90a): int32 values on the k-core
// path, float32 and bf16 rows on the GNN path (the float form, below).
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
//
// The float form (segment_sum_float_f32 / _bf16, further down) serves the GNN
// family's message aggregation: vals (E, F) float32 or bf16 in the edges'
// own order, summed into (n, F) through a CSR layout of the segment ids
// (`order`, a stable argsort of them, and `row_ptr`). It replaces the same
// TPU kernel, which is dtype-generic, on the path models/gnn takes: every
// scatter_sum of SchNet, EGNN, GraphCast and MACE. What bounds it: bytes, the
// E rows of vals gathered once and n x F outputs written once; a row's terms
// are summed in float32 in `order`, so the result is deterministic (unlike
// index_add_'s atomics) and rounded once to the output dtype. Design: one
// row per group of threads, the threads across F with 16-byte loads (4
// float32 or 8 bf16; element by element where F, the row stride or the base
// is not 16-byte aligned), every thread of a row reading the same order[j]
// (one broadcast load a warp), eight gathered rows in flight a thread before
// their adds, which stay in order. A row is walked by one group, so a row
// of 98,432 arcs sets the tail; splitting wide rows (fixed partials in a
// fixed order) is left for later.

#include <cuda_bf16.h>
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


// ---------------------------------------------------------------------- //
// The float form: out[r] = sum of vals[order[j]] for j in [row_ptr[r], row_ptr[r + 1])
// ---------------------------------------------------------------------- //

constexpr int kFloatThreads = 256;
constexpr int kFloatUnroll = 8;  // gathered rows in flight a thread

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Loads of kVec values (one 16-byte load, or one element), their float32 adds
// into acc in order, and the rounded store.
template <typename T, bool kVector>
struct Io;

template <>
struct Io<float, true> {
  static constexpr int kVec = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static void add(float* acc, const Raw& v) {
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  __device__ static void store(float* p, const float* acc) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <>
struct Io<float, false> {
  static constexpr int kVec = 1;
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static void add(float* acc, const Raw& v) { acc[0] += v; }
  __device__ static void store(float* p, const float* acc) { *p = acc[0]; }
};

template <>
struct Io<__nv_bfloat16, true> {
  static constexpr int kVec = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void add(float* acc, const Raw& v) {
    acc[0] += bf16_lo(v.x);
    acc[1] += bf16_hi(v.x);
    acc[2] += bf16_lo(v.y);
    acc[3] += bf16_hi(v.y);
    acc[4] += bf16_lo(v.z);
    acc[5] += bf16_hi(v.z);
    acc[6] += bf16_lo(v.w);
    acc[7] += bf16_hi(v.w);
  }
  __device__ static void store(__nv_bfloat16* p, const float* acc) {
    uint4 w;
    w.x = bf16_bits(acc[0]) | (bf16_bits(acc[1]) << 16);
    w.y = bf16_bits(acc[2]) | (bf16_bits(acc[3]) << 16);
    w.z = bf16_bits(acc[4]) | (bf16_bits(acc[5]) << 16);
    w.w = bf16_bits(acc[6]) | (bf16_bits(acc[7]) << 16);
    *reinterpret_cast<uint4*>(p) = w;
  }
};

template <>
struct Io<__nv_bfloat16, false> {
  static constexpr int kVec = 1;
  using Raw = unsigned short;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void add(float* acc, const Raw& v) { acc[0] += __uint_as_float((unsigned)v << 16); }
  __device__ static void store(__nv_bfloat16* p, const float* acc) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)bf16_bits(acc[0]);
  }
};

// Block (tx, ty): ty rows a block, tx threads a row across its F / kVec columns
// (looping where there are more columns than threads). vals' rows are ld
// elements apart; out is (n, F) contiguous.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kFloatThreads)
segment_sum_float_rows(const T* __restrict__ vals, long long ld, const long long* __restrict__ order,
                       const long long* __restrict__ row_ptr, T* __restrict__ out, long long n,
                       int F) {
  using IO = Io<T, kVector>;
  constexpr int V = IO::kVec;
  const long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= n) return;
  const long long b = __ldg(row_ptr + r), e = __ldg(row_ptr + r + 1);
  const int cols = F / V;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const T* col = vals + (long long)c * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    long long j = b;
    for (; j + kFloatUnroll <= e; j += kFloatUnroll) {
      long long o[kFloatUnroll];
      typename IO::Raw x[kFloatUnroll];
#pragma unroll
      for (int k = 0; k < kFloatUnroll; ++k) o[k] = __ldg(order + j + k);
#pragma unroll
      for (int k = 0; k < kFloatUnroll; ++k) x[k] = IO::load(col + o[k] * ld);
#pragma unroll
      for (int k = 0; k < kFloatUnroll; ++k) IO::add(acc, x[k]);
    }
    for (; j < e; ++j) IO::add(acc, IO::load(col + __ldg(order + j) * ld));
    IO::store(out + r * F + (long long)c * V, acc);
  }
}

template <typename T>
int launch_float(const void* vals, long long ld, const void* order, const void* row_ptr, void* out,
                 long long n, long long F, void* stream) {
  if (n < 0 || F < 1 || F > 0x7fffffffLL || ld < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  constexpr int V = Io<T, true>::kVec;
  const bool vec = F % V == 0 && ld % V == 0 && ((uintptr_t)vals & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  const long long cols = vec ? F / V : F;
  const int tx = (int)(cols < kFloatThreads ? cols : kFloatThreads);
  const int ty = kFloatThreads / tx;
  const long long blocks = (n + ty - 1) / ty;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 block((unsigned)tx, (unsigned)ty);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    segment_sum_float_rows<T, true><<<(unsigned)blocks, block, 0, s>>>(
        (const T*)vals, ld, (const long long*)order, (const long long*)row_ptr, (T*)out, n, (int)F);
  else
    segment_sum_float_rows<T, false><<<(unsigned)blocks, block, 0, s>>>(
        (const T*)vals, ld, (const long long*)order, (const long long*)row_ptr, (T*)out, n, (int)F);
  return (int)cudaGetLastError();
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

// vals (E, F) float32 / bf16 with rows ld elements apart, in the edges' order;
// order (E,) int64, a stable argsort of the segment ids; row_ptr (n+1,) int64,
// the CSR offsets after it; out (n, F) contiguous, of vals' dtype. One launch
// on `stream`; returns cudaGetLastError().
int segment_sum_float_f32(const void* vals, long long ld, const void* order, const void* row_ptr,
                          void* out, long long n, long long F, void* stream) {
  return launch_float<float>(vals, ld, order, row_ptr, out, n, F, stream);
}

int segment_sum_float_bf16(const void* vals, long long ld, const void* order, const void* row_ptr,
                           void* out, long long n, long long F, void* stream) {
  return launch_float<__nv_bfloat16>(vals, ld, order, row_ptr, out, n, F, stream);
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
