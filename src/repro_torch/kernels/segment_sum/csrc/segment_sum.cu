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
// The float form (segment_sum_float_f32 / _bf16, further down) serves the
// GNN family's message aggregation and the LM and MoE scatters: vals (E, F)
// float32 or bf16 in the edges' own order, summed into (n, F) through a CSR
// layout of the segment ids (`order`, a stable argsort of them, and
// `row_ptr`). It still replaces src/repro/kernels/segment_sum/kernel.py:
// _seg_kernel for float values: that TPU kernel is dtype-generic, and the
// float form is every scatter_sum of SchNet, EGNN, GraphCast and MACE.
//
// Its definition: row r's d arcs, in `order`, are cut into stretches of
// kStretch consecutive arcs, the last maybe shorter; each stretch is
// summed in float32 from 0 in that order, the row's stretch partials are
// added in float32 from 0 in stretch order, and the sum is rounded once to
// the output dtype. A row of at most kStretch arcs is one stretch, a single
// float32 sum in edge order. The result depends only on the row's own terms,
// never on the launch, the card or where other rows lie, and no atomics are
// used, so it is the same run to run (a training restart is held bit-exact
// on it). kStretch is part of the function: ops.STRETCH equals it, and the
// entry points refuse any other value.
//
// What bounds it: bytes, the E gathered rows of vals read once, the order and
// the row pointers, and n x F outputs written once: E F s + 8E + 8(n + 1) +
// n F s. The wide rows' partials add 2 x 4 F bytes a stretch of theirs
// (about 3.6 MB for a 98,426-arc row at F 1,152). What keeps a kernel from
// that bound is the degree skew and the empty rows: one group of threads
// walking a whole row of d arcs pays about d / 8 dependent memory latencies
// on one SM (19 ms for SPR's 98,426-arc hub), and a block a row turns
// 151,936 mostly empty LM rows into as many blocks.
//
// Design. Work items are (unit, column tile) pairs. A unit is one stretch of
// a row wider than kStretch, or a run of whole rows of at most kStretch arcs
// each (empty rows included, which write zeros). The layout's table cuts the
// rows into batches, the rows whose start falls in one block of
// kBatchItems rows and arcs; a unit merges as many batches as span 16 /
// kVpl rows and arcs (below), about 8 KB a warp whatever F is, so it holds
// at most 32 rows and few arcs beyond kStretch. A wide row is thus spread
// over ceil(d / kStretch) x tiles items on the whole card, and no item is
// long beside the others: the card's work ends together. The work table
// (ops.StretchTable, built with the layout: the wide rows, their stretches'
// offsets, each stretch's row, the batches' first rows) gives an item its
// arcs and, for a stretch, its slot of float32 scratch. A group of up to 32
// threads takes an item, the threads across its tile of F with 16-byte loads
// (4 float32 or 8 bf16; element by element where F, the row stride or the
// base is not 16-byte aligned). The blocks are persistent (as many as the
// card keeps resident) and their warps take items from a ticket counter in
// order, so the stretches start first and the blocks finish together. On
// the main path a group is a whole warp on the 16-byte path. The warp of a
// run of rows treats its arcs as one stream across the row ends and brings the
// gathered rows into a ring of kRing x 512 bytes of shared memory a warp
// with cp.async.cg, all stages but one in flight (the lanes load the order 32
// stream positions at a time and shuffles broadcast it), adds them from there
// in edge order and stores each row's sum as the stream passes its end; so a
// short row is no dependent chain of its own. It takes up to four tiles of
// 32 columns at once, so that it reads up to 2 KB of a gathered row together.
// A stretch's warp takes one tile, so that a wide row spreads further, and
// keeps kFloatUnroll gathered rows in flight in registers (the ring measured
// slower there); where the items are too few to fill the card a block is one
// warp, so that they spread over the SMs. Elsewhere (narrow F, unaligned
// views) each thread walks a run's rows one after another, in
// registers as well. A one-stretch row stores its rounded sum; a stretch of a
// wider row stores its float32 partial, and a second kernel, a thread a
// column, adds each wide row's partials in stretch order with kCombineUnroll
// loads in flight and rounds once, so no order depends on which block
// finishes first.

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
// The float form: out[r] = the stretch-wise sum of vals[order[j]] for j in
// [row_ptr[r], row_ptr[r + 1]) (the definition in the note at the top)
// ---------------------------------------------------------------------- //

constexpr long long kStretch = 128;  // arcs a stretch: ops.STRETCH
constexpr int kBatchItems = 4;       // rows and arcs a batch of the work table: ops.BATCH_ITEMS
constexpr int kRing = 16;            // cp.async stages of 512 bytes a warp
constexpr int kFloatThreads = 256;
constexpr int kFloatUnroll = 8;    // gathered rows in flight a thread, register version
constexpr int kCombineUnroll = 32;  // partials in flight a thread when a wide row's are added
constexpr int kMaxDevices = 64;

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

// V float32 partials, stored by a stretch of a wide row.
template <int V>
__device__ __forceinline__ void store_partial(float* p, const float* acc) {
  if constexpr (V == 1) {
    *p = acc[0];
  } else {
#pragma unroll
    for (int q = 0; q < V; q += 4)
      *reinterpret_cast<float4*>(p + q) = make_float4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The arcs [b, e) of stretch `unit` of a wide row, in `order`.
__device__ __forceinline__ void stretch_span(long long unit, const long long* __restrict__ row_ptr,
                                             const long long* __restrict__ wide_rows,
                                             const long long* __restrict__ wide_ptr,
                                             const long long* __restrict__ owner, long long& b,
                                             long long& e) {
  const long long w = __ldg(owner + unit);
  const long long r = __ldg(wide_rows + w);
  b = __ldg(row_ptr + r) + (unit - __ldg(wide_ptr + w)) * kStretch;
  const long long row_end = __ldg(row_ptr + r + 1);
  e = b + kStretch < row_end ? b + kStretch : row_end;
}

// acc += the rows vals[order[j]] at `col`, j in [b, e), in order: kFloatUnroll
// gathered rows in flight in registers.
template <typename T, bool kVector>
__device__ __forceinline__ void sum_in_registers(const T* col, long long ld,
                                                 const long long* __restrict__ order, long long b,
                                                 long long e, float* acc) {
  using IO = Io<T, kVector>;
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
}

// One item on the register path (any group, any F): a stretch into its
// partial, or each row of `merge` batches (rows of at most kStretch arcs)
// into its output, one after another.
template <typename T, bool kVector>
__device__ __forceinline__ void item_in_registers(
    const T* __restrict__ vals, long long ld, const long long* __restrict__ order,
    const long long* __restrict__ row_ptr, const long long* __restrict__ wide_rows,
    const long long* __restrict__ wide_ptr, const long long* __restrict__ owner,
    const long long* __restrict__ batches, T* __restrict__ out, float* __restrict__ partials,
    long long unit, long long n_stretches, long long n_batches, int merge, int F, int c) {
  using IO = Io<T, kVector>;
  constexpr int V = IO::kVec;
  const T* col = vals + (long long)c * V;
  float acc[V];
  if (unit < n_stretches) {
    long long b, e;
    stretch_span(unit, row_ptr, wide_rows, wide_ptr, owner, b, e);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    sum_in_registers<T, kVector>(col, ld, order, b, e, acc);
    store_partial<V>(partials + unit * F + (long long)c * V, acc);
    return;
  }
  const long long b0 = (unit - n_stretches) * merge;
  const long long r1 = __ldg(batches + (b0 + merge < n_batches ? b0 + merge : n_batches));
  for (long long r = __ldg(batches + b0); r < r1; ++r) {
    const long long b = __ldg(row_ptr + r), e = __ldg(row_ptr + r + 1);
    if (e - b > kStretch) continue;  // a wide row: its stretches sum it
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    sum_in_registers<T, kVector>(col, ld, order, b, e, acc);
    IO::store(out + r * F + (long long)c * V, acc);
  }
}

// One item of `merge` batches on the ring path (a whole warp, 16-byte
// loads, kVpl tiles of 32 columns: lane l's columns c0 + 32 k, k < kVpl). Its
// arcs form one stream (lane l holding row l's start, length and stream
// offset, for at most 32 rows; a wide row contributes none, and no store). The stream
// passes through the warp's ring of kRing / kVpl stages of kVpl x 512 bytes
// (ring[(stage * kVpl + k) * 32 + lane]), all stages but one in flight across
// row ends; lane l loads the
// order of stream position p + l a batch of 32 ahead (found by a search of
// the lanes' offsets) and the shuffles broadcast it. Each lane reads back
// only what its own cp.async wrote, so cp.async.wait_group orders the ring
// and no barrier is needed; a stage is refilled one step after it was read.
// A row's sum is stored when the stream passes its end, in row order, empty
// rows as zeros.
template <typename T, int kVpl>
__device__ __forceinline__ void item_in_ring(const T* __restrict__ vals, long long ld,
                                             const long long* __restrict__ order,
                                             const long long* __restrict__ row_ptr,
                                             const long long* __restrict__ batches,
                                             T* __restrict__ out, long long unit,
                                             long long n_stretches, long long n_batches,
                                             int merge, int F, int c0, uint4* ring, int lane) {
  using IO = Io<T, true>;
  constexpr int V = IO::kVec;
  constexpr int kStages = kRing / kVpl;
  bool active[kVpl];
#pragma unroll
  for (int k = 0; k < kVpl; ++k) active[k] = c0 + 32 * k < F / V;
  const T* col = vals + (long long)c0 * V;
  // this lane's row of the batch: arcs [sb, sb + len) of `order`
  const long long b0 = (unit - n_stretches) * merge;
  const long long r0 = __ldg(batches + b0);
  const int nseg =
      (int)(__ldg(batches + (b0 + merge < n_batches ? b0 + merge : n_batches)) - r0);
  long long sb = 0;
  int len = 0;
  bool keep = true;
  if (lane < nseg) {
    sb = __ldg(row_ptr + r0 + lane);
    const long long d = __ldg(row_ptr + r0 + lane + 1) - sb;
    keep = d <= kStretch;
    len = keep ? (int)d : 0;
  }
  int end = len;  // inclusive scan: the stream offset where this lane's row ends
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, end, o);
    if (lane >= o) end += v;
  }
  const int start = end - len;
  const int total = __shfl_sync(kFull, end, 31);
  // order of stream position q, for the lanes' q = base + lane: the last row starting at or
  // before q (an empty one is never last), then its arc
  auto order_at = [&](int base) -> long long {
    const int q = base + lane;
    int i = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      const int s_m = __shfl_sync(kFull, start, (i + step) & 31);
      if (i + step < nseg && s_m <= q) i += step;
    }
    const long long arc = __shfl_sync(kFull, sb, i) + (q - __shfl_sync(kFull, start, i));
    return q < total ? __ldg(order + arc) : 0;
  };
  long long o_cur = order_at(0), o_next = order_at(32);
  auto issue = [&](int j) {  // j ascends by one a call; uniform across the warp
    if (j >= total) return;
    if ((j & 31) == 0 && j > 0) {
      o_cur = o_next;
      o_next = order_at(j + 32);
    }
    const T* src = col + __shfl_sync(kFull, o_cur, j & 31) * ld;
    uint4* dst = ring + (j % kStages) * kVpl * 32 + lane;
#pragma unroll
    for (int k = 0; k < kVpl; ++k)
      if (active[k]) cp_async16(dst + k * 32, src + 32 * k * V);
  };
  float acc[kVpl][V];
#pragma unroll
  for (int k = 0; k < kVpl; ++k)
#pragma unroll
    for (int q = 0; q < V; ++q) acc[k][q] = 0.f;
  int seg = 0;  // the next row to store; uniform
  auto store_through = [&](int j) {  // store every row that ends at or before j
    while (seg < nseg && __shfl_sync(kFull, end, seg) <= j) {
      const bool keep_seg = __shfl_sync(kFull, (int)keep, seg);
#pragma unroll
      for (int k = 0; k < kVpl; ++k) {
        const long long at = (long long)(c0 + 32 * k) * V;
        if (active[k] && keep_seg) IO::store(out + (r0 + seg) * F + at, acc[k]);
#pragma unroll
        for (int q = 0; q < V; ++q) acc[k][q] = 0.f;
      }
      ++seg;
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < total; ++j) {
    store_through(j);
    cp_async_wait<kStages - 2>();  // groups 0..j have landed
    const uint4* src = ring + (j % kStages) * kVpl * 32 + lane;
#pragma unroll
    for (int k = 0; k < kVpl; ++k)
      if (active[k]) IO::add(acc[k], *reinterpret_cast<const typename IO::Raw*>(src + k * 32));
    issue(j + kStages - 1);  // into the stage read one step ago
    cp_async_commit();
  }
  store_through(total);
}

// Items, unit-major: the n_stretches stretches of wide rows, `tiles` tiles
// of `group` columns (of kVec values) each, then the n_batches batches in
// units of `merge` consecutive ones, `batch_tiles` tiles each, of kVpl x 32
// columns on the ring path (so a warp reads kVpl x 512 contiguous bytes of a
// gathered row at a time) and `group` on the register path. A warp takes 32 /
// group consecutive items at a time, the next ones left, from the ticket
// counter tickets[0], so the stretches go first and the items end together
// whatever their lengths. tickets[1] counts the warps done; both are 0 at the
// launch, and the last warp out sets them to 0 again for the next launch on
// the stream, so no other kernel or memset runs to clear them. kRingOn needs
// group == 32, the 16-byte path and kRing x 512 bytes of dynamic shared
// memory a warp.
template <typename T, bool kVector, bool kRingOn, int kVpl>
__global__ void __launch_bounds__(kFloatThreads)
segment_sum_float_stretches(const T* __restrict__ vals, long long ld,
                            const long long* __restrict__ order,
                            const long long* __restrict__ row_ptr,
                            const long long* __restrict__ wide_rows,
                            const long long* __restrict__ wide_ptr,
                            const long long* __restrict__ owner,
                            const long long* __restrict__ batches, T* __restrict__ out,
                            float* __restrict__ partials,
                            unsigned long long* __restrict__ tickets, long long n_stretches,
                            long long n_batches, int merge, long long items, int F, int group,
                            int tiles, int batch_tiles) {
  extern __shared__ uint4 s_ring[];
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / group;
  const long long stretch_items = n_stretches * tiles;
  uint4* ring = s_ring + (threadIdx.x >> 5) * kRing * 32;
  while (true) {
    __syncwarp();
    unsigned long long t = 0;
    if (lane == 0) t = atomicAdd(tickets, 1ull);
    const long long item = (long long)__shfl_sync(kFull, t, 0) * per_warp + lane / group;
    if (item - lane / group >= items) break;  // uniform across the warp
    if (item >= items) continue;
    const bool stretch = item < stretch_items;
    const int per_unit = stretch ? tiles : batch_tiles;
    const long long unit = stretch ? item / tiles
                                   : n_stretches + (item - stretch_items) / batch_tiles;
    const int tile = (int)(stretch ? item - unit * tiles
                                   : (item - stretch_items) - (unit - n_stretches) * per_unit);
    if (kRingOn && !stretch) {
      item_in_ring<T, kVpl>(vals, ld, order, row_ptr, batches, out, unit, n_stretches, n_batches,
                            merge, F, tile * 32 * kVpl + lane, ring, lane);
    } else {
      const int c = tile * group + (lane & (group - 1));
      if (c < F / Io<T, kVector>::kVec)
        item_in_registers<T, kVector>(vals, ld, order, row_ptr, wide_rows, wide_ptr, owner,
                                      batches, out, partials, unit, n_stretches, n_batches, merge,
                                      F, c);
    }
  }
  if (lane == 0) {
    __threadfence();  // this warp's last ticket is taken before it counts itself done
    const unsigned long long warps = (unsigned long long)gridDim.x * (blockDim.x >> 5);
    if (atomicAdd(tickets + 1, 1ull) == warps - 1) {
      tickets[0] = 0;
      tickets[1] = 0;
    }
  }
}

// Each wide row's partials added in stretch order, from 0, and rounded once:
// a thread a column of F, a warp 32 columns of one row (items (wide row,
// tile)), kCombineUnroll partials in flight a thread.
template <typename T>
__global__ void __launch_bounds__(kFloatThreads)
segment_sum_float_combine(const float* __restrict__ partials,
                          const long long* __restrict__ wide_rows,
                          const long long* __restrict__ wide_ptr, T* __restrict__ out,
                          long long items, int F, int tiles) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kFloatThreads / 32);
  for (long long item = (long long)blockIdx.x * (kFloatThreads / 32) + (threadIdx.x >> 5);
       item < items; item += warps) {
    const long long w = item / tiles;
    const int c = (int)(item - w * tiles) * 32 + lane;
    if (c >= F) continue;
    const float* col = partials + c;
    const long long k1 = __ldg(wide_ptr + w + 1);
    long long k = __ldg(wide_ptr + w);
    float acc = 0.f;
    for (; k + kCombineUnroll <= k1; k += kCombineUnroll) {
      float x[kCombineUnroll];
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u) x[u] = __ldg(col + (k + u) * F);
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u) acc += x[u];
    }
    for (; k < k1; ++k) acc += __ldg(col + k * F);
    Io<T, false>::store(out + __ldg(wide_rows + w) * F + c, &acc);
  }
}

// Blocks of `kernel` the current card keeps resident with `smem` bytes of
// dynamic shared memory each (the persistent grid), found once a device.
template <typename Kernel>
int resident_blocks(Kernel kernel, int smem, int* cache, cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  if (smem > 48 * 1024) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (*err != cudaSuccess) return 0;
  }
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFloatThreads, smem);
  if (*err != cudaSuccess) return 0;
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cache[dev] = blocks;
  return blocks;
}

// The stretches' and batches' kernel on a persistent grid (as many blocks as
// the card keeps resident), taking its items from the ticket counter. Where
// the items would not fill that grid (a few wide rows alone) a block is one
// warp, so that the items spread over the SMs.
template <typename T, bool kVector, bool kRingOn, int kVpl>
cudaError_t launch_stretches(const T* vals, long long ld, const long long* order,
                             const long long* row_ptr, const long long* wide_rows,
                             const long long* wide_ptr, const long long* owner,
                             const long long* batches, T* out, float* partials,
                             unsigned long long* tickets, long long n_stretches,
                             long long n_batches, int merge, long long items, int F, int group,
                             int tiles, int batch_tiles, cudaStream_t s) {
  static int cache[kMaxDevices] = {};
  auto kernel = segment_sum_float_stretches<T, kVector, kRingOn, kVpl>;
  const int warp_smem = kRingOn ? kRing * 32 * 16 : 0;
  cudaError_t err;
  const long long resident = resident_blocks(kernel, warp_smem * (kFloatThreads / 32), cache, &err);
  if (err != cudaSuccess) return err;
  const long long per_block = kFloatThreads / group;
  int threads = kFloatThreads;
  long long blocks = (items + per_block - 1) / per_block;
  if (items < resident * per_block) {
    threads = 32;
    blocks = (items + 32 / group - 1) / (32 / group);
  } else if (blocks > resident) {
    blocks = resident;
  }
  kernel<<<(unsigned)blocks, threads, warp_smem * (threads / 32), s>>>(
      vals, ld, order, row_ptr, wide_rows, wide_ptr, owner, batches, out, partials, tickets,
      n_stretches, n_batches, merge, items, F, group, tiles, batch_tiles);
  return cudaGetLastError();
}

template <typename T, bool kVector>
cudaError_t launch_float_path(const void* vals, long long ld, const void* order,
                              const void* row_ptr, const void* wide_rows, const void* wide_ptr,
                              const void* owner, const void* batches, void* out, void* partials,
                              void* tickets, int F, long long n_wide, long long n_stretches,
                              long long n_batches, cudaStream_t s) {
  constexpr int V = Io<T, kVector>::kVec;
  auto merge_of = [](int vpl) { return 16 / vpl > kBatchItems ? 16 / vpl / kBatchItems : 1; };
  const int cols = F / V;
  int group = 1;
  while (group < cols && group < 32) group <<= 1;
  const int tiles = (cols + group - 1) / group;
  // the batches' tiles on the ring path: 4, 2 or 1 x 32 columns, the widest that leaves no more
  // than a tenth of the lanes idle
  int vpl = 4;
  while (vpl > 1 && 10LL * ((cols + 32 * vpl - 1) / (32 * vpl) * 32 * vpl - cols) > cols) vpl >>= 1;
  const long long* rp = (const long long*)row_ptr;
  const long long* wr = (const long long*)wide_rows;
  const long long* wp = (const long long*)wide_ptr;
  const long long* ow = (const long long*)owner;
  const long long* od = (const long long*)order;
  const long long* bt = (const long long*)batches;
  unsigned long long* tk = (unsigned long long*)tickets;
  cudaError_t err;
  // an item merges enough batches (of kBatchItems rows and arcs each) to span 16 / kVpl rows
  // and arcs: about 8 KB of gathered rows and outputs a warp, which reads kVpl x 512 bytes of
  // each; at most 32 rows
#define SEGMENT_FLOAT_LAUNCH(RING, VPL, BATCH_TILES)                                              \
  launch_stretches<T, kVector, RING, VPL>(                                                       \
      (const T*)vals, ld, od, rp, wr, wp, ow, bt, (T*)out, (float*)partials, tk, n_stretches,    \
      n_batches, merge_of(VPL),                                                                  \
      n_stretches * tiles + (n_batches + merge_of(VPL) - 1) / merge_of(VPL) * (BATCH_TILES), F,  \
      group, tiles, BATCH_TILES, s)
  if constexpr (kVector) {
    const int bt4 = (cols + 127) / 128, bt2 = (cols + 63) / 64;
    if (group < 32) err = SEGMENT_FLOAT_LAUNCH(false, 1, tiles);
    else if (vpl == 4) err = SEGMENT_FLOAT_LAUNCH(true, 4, bt4);
    else if (vpl == 2) err = SEGMENT_FLOAT_LAUNCH(true, 2, bt2);
    else err = SEGMENT_FLOAT_LAUNCH(true, 1, tiles);
  } else {
    err = SEGMENT_FLOAT_LAUNCH(false, 1, tiles);
  }
#undef SEGMENT_FLOAT_LAUNCH
  if (err != cudaSuccess || n_wide == 0) return err;
  const int col_tiles = (F + 31) / 32;
  const long long warps = n_wide * col_tiles;
  const long long blocks = (warps + kFloatThreads / 32 - 1) / (kFloatThreads / 32);
  segment_sum_float_combine<T><<<(unsigned)(blocks < 65535 ? blocks : 65535), kFloatThreads, 0,
                                 s>>>((const float*)partials, wr, wp, (T*)out, warps, F,
                                      col_tiles);
  return cudaGetLastError();
}

template <typename T>
int launch_float(const void* vals, long long ld, const void* order, const void* row_ptr,
                 const void* wide_rows, const void* wide_ptr, const void* owner,
                 const void* batches, void* out, void* partials, void* tickets, long long n,
                 long long F, long long n_wide, long long n_stretches, long long n_batches,
                 long long stretch, void* stream) {
  if (stretch != kStretch || n < 0 || F < 1 || F > 0x7fffffffLL || ld < 1 || n_wide < 0 ||
      n_wide > n || n_stretches < 0 || (n_wide == 0) != (n_stretches == 0) || n_batches < 0 ||
      n_batches > n)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  constexpr int V = Io<T, true>::kVec;
  const bool vec = F % V == 0 && ld % V == 0 && ((uintptr_t)vals & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0 && ((uintptr_t)partials & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    return (int)launch_float_path<T, true>(vals, ld, order, row_ptr, wide_rows, wide_ptr, owner,
                                           batches, out, partials, tickets, (int)F, n_wide,
                                           n_stretches, n_batches, s);
  return (int)launch_float_path<T, false>(vals, ld, order, row_ptr, wide_rows, wide_ptr, owner,
                                          batches, out, partials, tickets, (int)F, n_wide,
                                          n_stretches, n_batches, s);
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
// the CSR offsets after it; wide_rows (n_wide,), wide_ptr (n_wide + 1,),
// owner (n_stretches,) and batches (n_batches + 1,) int64, the work table of
// row_ptr (ops.StretchTable) for `stretch` arcs a stretch, which must equal
// kStretch, and batches of kBatchItems rows and arcs; out (n, F)
// contiguous, of vals' dtype; partials (n_stretches, F)
// float32; tickets two int64 counters, 0 at the call, which the call leaves
// at 0 (a pair serves one stream: calls that may overlap need pairs of their
// own). Launches
// the stretches' kernel and, if n_wide > 0, the kernel that adds the
// partials, on `stream`; returns the first error.
int segment_sum_float_f32(const void* vals, long long ld, const void* order, const void* row_ptr,
                          const void* wide_rows, const void* wide_ptr, const void* owner,
                          const void* batches, void* out, void* partials, void* tickets,
                          long long n, long long F, long long n_wide, long long n_stretches,
                          long long n_batches, long long stretch, void* stream) {
  return launch_float<float>(vals, ld, order, row_ptr, wide_rows, wide_ptr, owner, batches, out,
                             partials, tickets, n, F, n_wide, n_stretches, n_batches, stretch,
                             stream);
}

int segment_sum_float_bf16(const void* vals, long long ld, const void* order, const void* row_ptr,
                           const void* wide_rows, const void* wide_ptr, const void* owner,
                           const void* batches, void* out, void* partials, void* tickets,
                           long long n, long long F, long long n_wide, long long n_stretches,
                           long long n_batches, long long stretch, void* stream) {
  return launch_float<__nv_bfloat16>(vals, ld, order, row_ptr, wide_rows, wide_ptr, owner,
                                     batches, out, partials, tickets, n, F, n_wide, n_stretches,
                                     n_batches, stretch, stream);
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
