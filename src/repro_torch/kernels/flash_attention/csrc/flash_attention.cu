// Flash attention forward (blockwise online softmax) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:_flash_kernel (through
// flash_attention_pallas and ops.flash_attention). That kernel walks a
// sequential TPU grid (bh, q block, kv block) and carries the running max m,
// the denominator l and the accumulator acc in VMEM scratch from one kv block
// to the next. Here one thread block owns one (bh, q tile) and loops over the
// kv tiles itself, with m, l and acc in registers.
//
// It computes exactly what _flash_kernel computes, for any Sq, Sk and GQA
// factor rep = Hq / Hkv (query head h reads kv head h / rep):
//   * scores q.k * scale with scale = 1/sqrt(d), float32 running max,
//     denominator and accumulator, out = acc / max(l, 1e-30);
//   * masks on absolute positions that start at 0 for q and k alike:
//     causal keeps k <= q, a window keeps k > q - window;
//   * masked scores are the FINITE -1e30, not -inf. A row masked everywhere
//     (only when Sq > Sk + window - 1) therefore gives every key p = 1 and
//     returns the mean of v over all Sk keys, as the reference does; and a
//     row that is masked over a first tile and sees a key later has that
//     tile's weight wiped by alpha = exp(-1e30 - m) = 0.
// Keys past Sk (the ragged last tile) are -inf and their rows of V are zero,
// so they weigh nothing even in a row masked everywhere.
//
// Tile skipping. A block visits only the kv tiles that hold a key some of its
// rows may see (above the causal diagonal and below the window are skipped).
// That is exact only where every row of the block sees at least one key; a
// row masked everywhere needs all Sk keys, so a block holding one visits every
// tile. Whether a row is masked everywhere is monotone in its position, so the
// block's first and last rows decide it.
//
// Two kernels:
//   * flash_mma_bf16<D> (D = 64, 128), the serving path: 4 warps, 64 query
//     rows (16 a warp), 64-key tiles of K and V staged in shared memory,
//     QK^T and PV on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//     accumulate). P is rounded to bf16 before the PV product, as the TPU
//     kernel rounds p to v's dtype; l sums the unrounded p. Scores are kept in
//     the log2 domain (exp2 of s * scale * log2 e), which changes only the
//     last bits of exp.
//   * flash_rowwise<T, D> (float32 for every D, and bf16 for D < 64): four
//     threads share a query row, each holding every fourth of its D dims of q
//     and acc in registers; 32-key tiles in shared memory as float; CUDA-core
//     FMAs and expf. Float32 inputs need it: a tensor-core product would round
//     them to bf16 or tf32.
// Inputs are read in place through their batch, sequence and head strides
// (element strides, last dim contiguous, rows 16-byte aligned: the wrapper
// copies anything else). No cp.async, TMA or wgmma yet: each tile is loaded,
// then computed on.
//
// What bounds it: operations. At the serve shape (bf16, B*Hq = 128,
// Sq = Sk = 2048, d = 64, causal) the QK^T and PV products are
// 4 * 128 * 64 * 2048 * 2049 / 2 = 6.9e10 FLOP, 0.069 ms at 989 TFLOP/s,
// against 0.040 ms for the 134 MB of q, k, v and o at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMaskFill = -1e30f;  // the reference's finite fill
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // batch, sequence, head strides (elements)
  int Hq, rep, Sq, Sk;
  int causal, has_window, window;
  float scale;
};

__device__ __forceinline__ bool masked(const Args& a, int qp, int key) {
  if (a.causal && key > qp) return true;
  return a.has_window && (long long)key <= (long long)qp - a.window;
}

// The keys [lo, hi] a query at position qp sees; lo > hi when it sees none.
__device__ __forceinline__ void key_range(const Args& a, int qp, int& lo, int& hi) {
  hi = a.causal ? min(qp, a.Sk - 1) : a.Sk - 1;
  long long l = a.has_window ? (long long)qp - a.window + 1 : 0;
  lo = (int)max(0LL, min(l, (long long)a.Sk));
}

// The kv tiles [t0, t1] a block of query rows [q0, q1) must visit.
__device__ __forceinline__ void tile_range(const Args& a, int q0, int q1, int bk, int& t0,
                                           int& t1) {
  int lo0, hi0, lo1, hi1;
  key_range(a, q0, lo0, hi0);
  key_range(a, q1 - 1, lo1, hi1);
  if (lo0 > hi0 || lo1 > hi1) {  // a row masked everywhere: it needs every key
    t0 = 0;
    t1 = (a.Sk - 1) / bk;
  } else {
    t0 = lo0 / bk;
    t1 = hi1 / bk;
  }
}

// ------------------------------------------------------------------------- //
// bf16 tensor-core kernel
// ------------------------------------------------------------------------- //

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + rows) of a (., D) bf16 matrix with row stride `stride` into
// shared memory of row pitch LD; rows at or past `limit` are zero.
template <int D, int LD>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long stride, int r0, int rows, int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_mma_bf16(const Args a) {
  constexpr int BQ = 64, BK = 64, LD = D + 8;  // +16 bytes a row: no bank conflicts
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;
  const unsigned short* Ku = reinterpret_cast<const unsigned short*>(Ks);
  const unsigned short* Vu = reinterpret_cast<const unsigned short*>(Vs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.Hq, h = bh % a.Hq, hk = h / a.rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int q1 = min(q0 + BQ, a.Sq);
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qs[0] + (long long)h * a.qs[2];
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + (long long)hk * a.ks[2];
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + (long long)hk * a.vs[2];

  stage_bf16<D, LD>(Qs, qg, a.qs[1], q0, BQ, a.Sq);
  __syncthreads();
  uint32_t qa[D / 16][4];  // this warp's 16 rows of q as mma A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = Qs + (warp * 16 + g) * LD + kk * 16 + t * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }

  int t0, t1;
  tile_range(a, q0, q1, BK, t0, t1);
  const int qp[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};  // this thread's rows
  const float sl2 = a.scale * 1.4426950408889634f;
  float m[2] = {kMaskFill, kMaskFill}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int kt = t0; kt <= t1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    stage_bf16<D, LD>(Ks, kg, a.ks[1], k0, BK, a.Sk);
    stage_bf16<D, LD>(Vs, vg, a.vs[1], k0, BK, a.Sk);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (nt * 8 + g) * LD + kk * 16 + t * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(Ku + off);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(Ku + off + 8);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }

    // scale and mask; the row max over the 4 threads that share a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t * 2 + (e & 1);
        float x = s[nt][e] * sl2;
        if (key >= a.Sk)
          x = -INFINITY;
        else if (masked(a, qp[e >> 1], key))
          x = kMaskFill;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], mnew[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      mnew[r] = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - mnew[r]);
      m[r] = mnew[r];
      l[r] *= alpha[r];  // a partial sum of this thread's columns; reduced at the end
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - mnew[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += P V: the S accumulators are P's A fragments (two n-tiles per k-step);
    // V's B fragments pair keys 2t, 2t+1 of one column
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int off = (kk * 16 + t * 2) * LD + dn * 8 + g;
        const uint32_t b0 = (uint32_t)Vu[off] | ((uint32_t)Vu[off + LD] << 16);
        const uint32_t b1 = (uint32_t)Vu[off + 8 * LD] | ((uint32_t)Vu[off + 9 * LD] << 16);
        mma_bf16(acc[dn], pa, b0, b1);
      }
    }
  }

  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] + (long long)h * a.os[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const float den = fmaxf(l[r], 1e-30f);
    if (qp[r] >= a.Sq) continue;
    __nv_bfloat16* row = og + (long long)qp[r] * a.os[1];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(row + dn * 8 + t * 2) =
          pack_bf16(acc[dn][2 * r] / den, acc[dn][2 * r + 1] / den);
  }
}

// ------------------------------------------------------------------------- //
// float32 (and small-d bf16) CUDA-core kernel
// ------------------------------------------------------------------------- //

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// p as the PV product sees it: rounded to bf16 for bf16 inputs, as the TPU kernel rounds it
template <typename T>
__device__ __forceinline__ float pv_weight(float p) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) return __bfloat162float(__float2bfloat16(p));
  return p;
}

template <typename T, int D>
__global__ void __launch_bounds__(128) flash_rowwise(const Args a) {
  constexpr int BQ = 32, BK = 32, PER = D / 4;
  __shared__ float Ks[BK][D];
  __shared__ float Vs[BK][D];

  const int row = threadIdx.x >> 2, c = threadIdx.x & 3;  // dims c, c + 4, c + 8, ...
  const int bh = blockIdx.x, b = bh / a.Hq, h = bh % a.Hq, hk = h / a.rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q1 = min(q0 + BQ, a.Sq);
  const int qp = q0 + row;
  const bool live = qp < a.Sq;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + (long long)h * a.qs[2];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + (long long)hk * a.ks[2];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + (long long)hk * a.vs[2];

  float q[PER], acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    q[i] = live ? to_f32(qg[(long long)qp * a.qs[1] + i * 4 + c]) : 0.f;
    acc[i] = 0.f;
  }
  int t0, t1;
  tile_range(a, q0, q1, BK, t0, t1);
  float m = kMaskFill, l = 0.f;

  for (int kt = t0; kt <= t1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D; i += blockDim.x) {
      const int r = i / D, col = i % D, key = k0 + r;
      const bool in = key < a.Sk;
      Ks[r][col] = in ? to_f32(kg[(long long)key * a.ks[1] + col]) : 0.f;
      Vs[r][col] = in ? to_f32(vg[(long long)key * a.vs[1] + col]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) part = fmaf(q[i], Ks[j][i * 4 + c], part);
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      const int key = k0 + j;
      float x = part * a.scale;
      if (key >= a.Sk)
        x = -INFINITY;
      else if (masked(a, qp, key))
        x = kMaskFill;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float mnew = fmaxf(m, mx);
    const float alpha = expf(m - mnew);
    m = mnew;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - mnew);
      l += p;
      const float w = pv_weight<T>(p);
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = fmaf(w, Vs[j][i * 4 + c], acc[i]);
    }
  }

  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  T* og = static_cast<T*>(a.o) + b * a.os[0] + (long long)h * a.os[2] + (long long)qp * a.os[1];
#pragma unroll
  for (int i = 0; i < PER; ++i) store(og + i * 4 + c, acc[i] / den);
}

template <int D>
cudaError_t launch_mma(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int smem = (64 + 2 * 64) * (D + 8) * 2;
  static bool attribute_set = false;
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_mma_bf16<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  grid.y = (a.Sq + 63) / 64;
  flash_mma_bf16<D><<<grid, 128, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rowwise(const Args& a, int d, dim3 grid, cudaStream_t stream) {
  grid.y = (a.Sq + 31) / 32;
  switch (d) {
    case 8: flash_rowwise<T, 8><<<grid, 128, 0, stream>>>(a); break;
    case 16: flash_rowwise<T, 16><<<grid, 128, 0, stream>>>(a); break;
    case 32: flash_rowwise<T, 32><<<grid, 128, 0, stream>>>(a); break;
    case 64: flash_rowwise<T, 64><<<grid, 128, 0, stream>>>(a); break;
    case 128: flash_rowwise<T, 128><<<grid, 128, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, d), k/v (B, Sk, Hkv, d), o (B, Sq, Hq, d), all of `dtype`
// (0 float32, 1 bfloat16) with their last dim contiguous. `strides` holds the
// batch, sequence and head strides of q, k, v and o in that order (12 values,
// in elements). `window` is read when has_window is set. Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const long long* strides, int B, int Hq, int Hkv, int Sq, int Sk, int d,
                        int dtype, int causal, int has_window, int window, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Sk <= 0 || Hkv <= 0 || Hq % Hkv || (long long)B * Hq >= (1LL << 31) ||
      (Sq + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.Hq = Hq;
  a.rep = Hq / Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.has_window = has_window;
  a.window = window;
  a.scale = 1.0f / sqrtf((float)d);
  const dim3 grid((unsigned)(B * Hq), 1);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 1 && d == 64)
    err = launch_mma<64>(a, grid, st);
  else if (dtype == 1 && d == 128)
    err = launch_mma<128>(a, grid, st);
  else if (dtype == 1)
    err = launch_rowwise<__nv_bfloat16>(a, d, grid, st);
  else if (dtype == 0)
    err = launch_rowwise<float>(a, d, grid, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
