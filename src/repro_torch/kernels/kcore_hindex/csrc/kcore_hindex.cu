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
// int32 is written per row: 4RW + 8R bytes against 3.35 TB/s.
//
// Design, by width; each reads the row from HBM once:
//
//   W <= 2048   the row in registers: G threads per row (1 up to W = 32, 8 up
//               to 128, 32 beyond), each holding at most 64 of its values.
//               The row is read once, in 16-byte chunks dealt out in turn so
//               that a group reads contiguous memory; a probe counts in
//               registers and sums over the group with shuffles.
//   W > 2048    one block of 512 threads per row (the widest bucket, W up to
//               ~98K at soc-pokec scale: 384 KB, more than registers or
//               shared memory hold). The probes' outcomes depend only on the
//               counts C(k) = #{j : vals_j >= k}. While lo < hi every probe has
//               1 <= k = mid <= hi <= est_u, and a count at k > W is at most
//               W < k, so clipping the values at cap = min(est_u, W) decides
//               every probe as clipping at est_u does. A pass bins the clipped
//               row into a window of at most 8192 unit-wide bins
//               [base, base + nb) in shared memory plus one count of
//               everything above it, and turns the bins into suffix counts.
//               The block then replays the probes from those counts: a probe
//               is exact inside the window, and outside it whenever the
//               window's edge settles it (C(k) <= C(base + nb) < mid fails;
//               C(k) >= C(base) >= mid passes). A probe the window cannot
//               decide ends the pass, and the next pass moves the window onto
//               the search's interval (or centres it on that probe), so each
//               pass decides at least one probe. When cap <= 8192 (every row
//               of the soc-pokec analogue's widest bucket, at the degree seed
//               and at the cores) the first window holds every probe: one
//               pass over the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroupRowMax = 2048;  // wider rows take a block each
constexpr int kGroupThreads = 256;
constexpr int kBlockThreads = 512;
constexpr int kWindow = 8192;

// Replays probes `it`, `it` + 1, ... of n_iters from (lo, hi) against the
// suffix counts S[i] = #{j : v_j >= base + i}, i in [0, nb] (S[nb] counts all
// values at or above base + nb). Stops at a probe the counts do not decide
// and returns false; returns true when no probe is left to run.
__device__ __forceinline__ bool replay(const int* S, int base, int nb, int n_iters, int& lo,
                                       int& hi, int& it) {
  for (; it < n_iters && lo < hi; ++it) {
    const int mid = (lo + hi + 1) >> 1;
    const long long i = (long long)max(mid, 1) - base;
    bool pass;
    if (i < 0) {          // C(k) >= C(base) = S[0]
      if (S[0] < mid) return false;
      pass = true;
    } else if (i > nb) {  // C(k) <= C(base + nb) = S[nb]
      if (S[nb] >= mid) return false;
      pass = false;
    } else {
      pass = S[i] >= mid;
    }
    if (pass) lo = mid; else hi = mid - 1;
  }
  return true;
}

// The window of the next pass after a probe at (lo, hi) went undecided: all of
// [lo + 1, hi] (every mid to come) if it fits, else centred on the probe.
__device__ __forceinline__ int next_base(int lo, int hi) {
  if ((long long)hi - lo <= kWindow) return lo + 1;
  const int mid = (lo + hi + 1) >> 1;
  return max(lo + 1, mid - kWindow / 2);
}

__device__ __forceinline__ void bin(int x, int cap, int base, int nb, int* S, int& over) {
  const int i = min(x, cap) - base;
  if (i >= nb) ++over;
  else if (i >= 0) atomicAdd(&S[i], 1);
}

// G threads per row, each holding VALS of its values in registers (the row's
// 16-byte chunks dealt out in turn, so a group reads contiguous memory). A
// probe counts in registers and sums over the group with shuffles. Rows that
// have settled (lo == hi, a fixpoint of a probe) keep probing until every row
// of the warp has, so the shuffles always see the whole warp.
template <int VALS, int G>
__global__ void __launch_bounds__(kGroupThreads)
hindex_group_rows(const int* __restrict__ nbr, const int* __restrict__ est_u,
                  int* __restrict__ out, long long rows, int width, int n_iters, int vec) {
  const long long r = (blockIdx.x * (long long)kGroupThreads + threadIdx.x) / G;
  const int g = threadIdx.x % G;
  const bool live = r < rows;
  const int eu = live ? est_u[r] : 0;
  const int* row = nbr + r * width;
  int v[VALS];
  if (vec) {  // width % 4 == 0 and 16-byte aligned rows
    const int4* row4 = reinterpret_cast<const int4*>(row);
#pragma unroll
    for (int j = 0; j < VALS / 4; ++j) {
      const int c = j * G + g;
      int4 x = make_int4(0, 0, 0, 0);
      if (live && 4 * c < width) x = row4[c];
      v[4 * j] = min(x.x, eu);
      v[4 * j + 1] = min(x.y, eu);
      v[4 * j + 2] = min(x.z, eu);
      v[4 * j + 3] = min(x.w, eu);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VALS; ++j) {
      const int c = j * G + g;
      v[j] = live && c < width ? min(row[c], eu) : 0;
    }
  }
  int lo = 0, hi = eu;
  for (int it = 0; it < n_iters; ++it) {
    if (!__any_sync(kFull, lo < hi)) break;
    const int mid = (lo + hi + 1) >> 1;
    const int k = max(mid, 1);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < VALS; ++j) cnt += v[j] >= k;  // padding is 0 < k
#pragma unroll
    for (int o = 1; o < G; o <<= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
    if (cnt >= mid) lo = mid; else hi = mid - 1;
  }
  if (live && g == 0) out[r] = lo;
}

__global__ void __launch_bounds__(kBlockThreads)
hindex_block_rows(const int* __restrict__ nbr, const int* __restrict__ est_u,
                  int* __restrict__ out, int width, int n_iters, int vec) {
  __shared__ int S[kWindow + 1];
  __shared__ int part[kBlockThreads / 32];
  const long long r = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int eu = est_u[r];
  const int cap = min(eu, width);
  const int* row = nbr + r * (long long)width;
  // every thread replays the same probes from the same counts, so lo, hi,
  // it and base stay block-uniform without being broadcast
  int lo = 0, hi = eu, it = 0, base = 1;
  while (it < n_iters && lo < hi) {
    const int nb = (int)min((long long)kWindow, max(0LL, (long long)cap - base + 1));
    for (int i = tid; i <= nb; i += kBlockThreads) S[i] = 0;
    __syncthreads();
    int over = 0;
    if (vec) {
      const int4* row4 = reinterpret_cast<const int4*>(row);
#pragma unroll 4
      for (int j = tid; j < (width >> 2); j += kBlockThreads) {
        const int4 x = row4[j];
        bin(x.x, cap, base, nb, S, over);
        bin(x.y, cap, base, nb, S, over);
        bin(x.z, cap, base, nb, S, over);
        bin(x.w, cap, base, nb, S, over);
      }
    } else {
      for (int j = tid; j < width; j += kBlockThreads) bin(row[j], cap, base, nb, S, over);
    }
    over = __reduce_add_sync(kFull, over);
    if (lane == 0) part[warp] = over;
    __syncthreads();  // the histogram and the warps' over counts are complete
    if (tid == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < kBlockThreads / 32; ++w) total += part[w];
      S[nb] = total;
    }
    __syncthreads();
    // suffix sums of S[0, nb]: a run of `per` entries a thread (odd: no bank
    // conflicts), then the runs' totals across the block
    const int n = nb + 1;
    const int per = ((n + kBlockThreads - 1) / kBlockThreads) | 1;
    const int a = min(tid * per, n), b = min(a + per, n);
    int sum = 0;
    for (int i = a; i < b; ++i) sum += S[i];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_down_sync(kFull, incl, o);
      if (lane + o < 32) incl += t;
    }
    if (lane == 0) part[warp] = incl;  // this warp's total
    __syncthreads();
    int run = incl - sum;
    for (int w = warp + 1; w < kBlockThreads / 32; ++w) run += part[w];
    for (int i = b - 1; i >= a; --i) {
      run += S[i];
      S[i] = run;
    }
    __syncthreads();
    if (replay(S, base, nb, n_iters, lo, hi, it)) break;
    base = next_base(lo, hi);
    __syncthreads();  // every thread is done reading S and part before the next pass
  }
  if (tid == 0) out[r] = lo;
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
  const int vec = (reinterpret_cast<uintptr_t>(nbr) % 16 == 0) && (width % 4 == 0);
  // (values a thread, threads a row) by width: the row in registers, at most 64 values a thread
  if (width <= kGroupRowMax) {
    const int g = width <= 32 ? 1 : width <= 128 ? 8 : 32;
    const unsigned blocks = (unsigned)((rows * g + kGroupThreads - 1) / kGroupThreads);
    if (width <= 8)
      hindex_group_rows<8, 1><<<blocks, kGroupThreads, 0, s>>>(nbr, eu, o, rows, (int)width,
                                                              n_iters, vec);
    else if (width <= 32)
      hindex_group_rows<32, 1><<<blocks, kGroupThreads, 0, s>>>(nbr, eu, o, rows, (int)width,
                                                               n_iters, vec);
    else if (width <= 128)
      hindex_group_rows<16, 8><<<blocks, kGroupThreads, 0, s>>>(nbr, eu, o, rows, (int)width,
                                                               n_iters, vec);
    else if (width <= 512)
      hindex_group_rows<16, 32><<<blocks, kGroupThreads, 0, s>>>(nbr, eu, o, rows, (int)width,
                                                                n_iters, vec);
    else
      hindex_group_rows<64, 32><<<blocks, kGroupThreads, 0, s>>>(nbr, eu, o, rows, (int)width,
                                                                n_iters, vec);
  } else {
    hindex_block_rows<<<(unsigned)rows, kBlockThreads, 0, s>>>(nbr, eu, o, (int)width, n_iters,
                                                               vec);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
