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
//   * flash_wgmma_bf16<D> (D = 64, 128), the serving path. A block owns 128
//     query rows: two consumer warpgroups of 64 rows each, and a producer
//     warpgroup that gives most of its registers to them (setmaxnreg). One
//     producer thread loads Q once and then keeps a ring of 3 K/V tiles (128
//     keys for D = 64, 64 for D = 128) full with TMA (cp.async.bulk.tensor,
//     64-column boxes with the 128-byte swizzle, completion on an mbarrier a
//     stage), so the next tiles load while the current one is computed; the
//     consumers release a stage on a second mbarrier once their products
//     have read it. Each consumer warpgroup computes S = Q K^T with wgmma
//     (m64nNk16, bf16 in, float32 accumulate, Q and K from shared memory,
//     both K-major), the online softmax in registers in the log2 domain
//     (ex2.approx of s * scale * log2 e, which changes only the last bits of
//     exp), and O += P V with wgmma, P from registers rounded to bf16 (as the
//     TPU kernel rounds p to v's dtype; l sums the unrounded p) and V from
//     shared memory in its key-major layout (the transposed-B form). Masks
//     are applied only on the tiles that the causal diagonal, the window or
//     the end of the keys cut; interior tiles skip them. Within a warpgroup,
//     one tile's PV product overlaps the next tile's softmax. Blocks walk one
//     head's q tiles, longest causal rows first, before the next head's, so
//     the blocks in flight share K and V in L2.
//   * flash_rowwise<T, D> (float32 for every D, and bf16 for D < 64): four
//     threads share a query row, each holding every fourth of its D dims of q
//     and acc in registers; 32-key tiles in shared memory as float; CUDA-core
//     FMAs and expf. Float32 inputs need it: a tensor-core product would round
//     them to bf16 or tf32.
// Inputs are read in place through their batch, sequence and head strides
// (element strides, last dim contiguous, rows 16-byte aligned: the wrapper
// copies anything else). The TMA descriptors (cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so libcuda is not linked) are 4-D
// (d, S, H, B) maps over those strides, passed as __grid_constant__
// parameters; rows past S come in as zeros.
//
// What bounds it: operations. At the serve shape (bf16, B*Hq = 128,
// Sq = Sk = 2048, d = 64, causal) the QK^T and PV products are
// 4 * 128 * 64 * 2048 * 2049 / 2 = 6.9e10 FLOP, 0.069 ms at 989 TFLOP/s,
// against 0.040 ms for the 134 MB of q, k, v and o at 3.35 TB/s; the 2.7e8
// exponentials take as long again on the special-function units (16 a cycle
// an SM). A warpgroup's wgmma issue does not return before the products ahead
// of it have run, so each warpgroup alternates products and softmax, and only
// the other warpgroup's work fills the gaps.

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMaskFill = -1e30f;  // the reference's finite fill
constexpr unsigned kFull = 0xffffffffu;
// an error a tensor-map descriptor was refused with: kTmaError + its CUresult
constexpr int kTmaError = 100000;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------------- //
// Hopper primitives: mbarriers, TMA, wgmma
// ------------------------------------------------------------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival, and `bytes` more for the barrier's phase to wait on
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed. A wait
// within a block lasts at most a tile's loads or products; one that outlasts
// 2^26 tries is a fault, and traps (the launch fails) rather than hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// a box of the 4-D tensor map at coordinates (c0, c1, c2, c3), completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this thread's committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of wgmma's registers across the async product
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma_ss_nN: D (64 x N, float32) = A B + (scale_d ? D : 0), A (64 x 16) and
// B (16 x N) bf16 in shared memory, both K-major. wgmma_rs_nN: D += A B, A from
// registers (mma.m16n8k16's A fragments, one 16-row slice a warp), B read
// transposed (N-major) from shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------------------- //
// bf16 tensor-core kernel (wgmma, TMA ring, warp-specialised)
// ------------------------------------------------------------------------- //

// Tile shapes by head dim. Shared memory holds Q (128 x D bf16) and a ring of
// 3 K and V tiles; registers cap the tiles' sizes (S, P and O of a thread).
template <int D>
struct Tile {
  static constexpr int kRows = 128;                 // query rows: two warpgroups of 64
  static constexpr int kKeys = D == 64 ? 128 : 64;  // keys of a K/V tile
  static constexpr int kStages = 3;                 // K/V tiles in the ring
  static constexpr int kHalves = D / 64;            // 64-column (128-byte) swizzle atoms across d
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kKVBytes = kKeys * D * 2;    // one tile of K, or of V
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + (2 * kStages + 1) * 8;
};
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// registers a thread: 168 at launch (the register file of each of the SM's four
// quarters holds three warps); the producer warpgroup gives most of its share
// to the consumers, 128 x (40 + 2 x 232) = 384 x 168
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Args a) {
  using T = Tile<D>;
  constexpr int BQ = T::kRows, BK = T::kKeys, ST = T::kStages;
  constexpr int NS = BK / 2, NO = D / 2;  // accumulator registers of S and of O a thread
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes; every tile starts on such a boundary.
  // Each tile is kHalves 64-column parts of (rows x 128 bytes), one TMA box each.
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + T::kQBytes;
  unsigned char* vs = ks + ST * T::kKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + ST * T::kKVBytes);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  // blocks in launch order walk the q tiles of one head before the next head's,
  // longest causal rows first: the blocks running at once share a few heads'
  // K and V through L2, where one head per block would stream them from HBM
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt, b = bh / a.Hq, h = bh % a.Hq, hk = h / a.rep;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * BQ;
  const int q1 = min(q0 + BQ, a.Sq);
  int t0, t1;
  tile_range(a, q0, q1, BK, t0, t1);
  const int n_tiles = t1 - t0 + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, read from lane 0 so that the compiler sees it uniform across each warp
  const int role = __shfl_sync(kFull, (int)(threadIdx.x / 128), 0);
  if (role == kConsumers / 128) {  // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qbar, T::kQBytes);
      for (int hf = 0; hf < T::kHalves; ++hf)
        tma_load(qs + hf * BQ * 128, &tq, qbar, hf * 64, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST, k0 = (t0 + i) * BK;
        if (i >= ST) mbar_wait(&empty[s], (i / ST - 1) & 1);  // its last tile is consumed
        mbar_expect_tx(&full[s], 2 * T::kKVBytes);
        for (int hf = 0; hf < T::kHalves; ++hf) {
          tma_load(ks + s * T::kKVBytes + hf * BK * 128, &tk, &full[s], hf * 64, k0, hk, b);
          tma_load(vs + s * T::kKVBytes + hf * BK * 128, &tv, &full[s], hf * 64, k0, hk, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

    // a consumer warpgroup: rows [qa, qa + 64) of the tile
    const int wg = role;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int qa = q0 + wg * 64;
    const int rq = qa + warp * 16 + g;  // this thread's rows: rq and rq + 8
    const float sl2 = a.scale * 1.4426950408889634f;
    const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
    const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);

    // accumulator layout (wgmma m64nN): register 4j + e holds row rq + 8 (e >> 1),
    // column 8j + 2t + (e & 1)
    float m[2] = {kMaskFill, kMaskFill}, l[2] = {0.f, 0.f}, alpha[2];
    float sc[NS], o[NO];
    uint32_t pa[BK / 16][4];  // P as wgmma's A fragments: keys [16 kk, 16 kk + 16)
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;

    // S = Q K^T of tile i into sc, over d in steps of 16: 32 bytes further along
    // the swizzled rows, the next 64-column part every 4 steps
    auto issue_qk = [&](int i) {
      const uint32_t kb = k_addr + (i % ST) * T::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = sw128_desc(q_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t db = sw128_desc(kb + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024);
        if constexpr (BK == 128)
          wgmma_ss_n128(sc, da, db, kk > 0);
        else
          wgmma_ss_n64(sc, da, db, kk > 0);
      }
    };
    // O += P V of tile i, over its keys in steps of 16 (16 swizzled rows of V,
    // 2048 bytes); V is key-major, so B is read transposed, its 64-column parts
    // BK rows apart
    auto issue_pv = [&](int i) {
      const uint32_t vb = v_addr + (i % ST) * T::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sw128_desc(vb + kk * 2048, BK * 128, 1024);
        if constexpr (D == 64)
          wgmma_rs_n64(o, pa[kk], db);
        else
          wgmma_rs_n128(o, pa[kk], db);
      }
    };
    // the online softmax of tile i's scores: sc becomes p = exp2(x - m), with x the
    // scaled (and masked) score and m the new running max; alpha rescales the old
    // l and acc. Masks only where the diagonal, the window or the end of the keys
    // cuts the tile.
    auto softmax = [&](int i) {
      const int k0 = (t0 + i) * BK;
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[j] *= sl2;
      const bool edge = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > qa) ||
                        (a.has_window && (long long)k0 <= (long long)qa + 63 - a.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int key = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
          if (key >= a.Sk)
            sc[j] = -INFINITY;
          else if (masked(a, rq + 8 * ((j >> 1) & 1), key))
            sc[j] = kMaskFill;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};  // the row max over the 4 threads that share a row
#pragma unroll
      for (int j = 0; j < NS; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float mnew = fmaxf(m[r], mx[r]);
        alpha[r] = fast_exp2(m[r] - mnew);
        m[r] = mnew;
        l[r] *= alpha[r];  // a partial sum of this thread's columns; reduced at the end
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        sc[j] = fast_exp2(sc[j] - m[(j >> 1) & 1]);
        l[(j >> 1) & 1] += sc[j];
      }
    };
    // rescale acc by alpha and round p to bf16 as P's fragments; PV of the previous
    // tile must be complete
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] *= alpha[(j >> 1) & 1];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        pa[j / 2][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    };

    // Tile i - 1's PV product runs on the tensor cores while tile i's softmax
    // runs on the CUDA cores: issue QK(i) and PV(i - 1) together, wait for
    // QK(i) alone, compute its softmax, then wait for PV(i - 1) and release
    // that tile's stage. The other warpgroup's products and softmax interleave
    // with these on the same SM.
    mbar_wait(qbar, 0);
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NS>(sc);
    softmax(0);
    rescale_and_pack();
    for (int i = 1; i < n_tiles; ++i) {
      mbar_wait(&full[i % ST], (i / ST) & 1);
      fence_regs<NO>(o);
      wgmma_fence();
      issue_qk(i);
      wgmma_commit();
      issue_pv(i - 1);
      wgmma_commit();
      wgmma_wait<1>();  // QK(i) is done; PV(i - 1) may still run
      fence_regs<NS>(sc);
      softmax(i);
      wgmma_wait<0>();
      fence_regs<NO>(o);
      mbar_arrive(&empty[(i - 1) % ST]);  // this thread is done with tile i - 1's stage
      rescale_and_pack();
    }
    fence_regs<NO>(o);
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(o);

    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] + (long long)h * a.os[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const float den = fmaxf(l[r], 1e-30f);
      const int row = rq + 8 * r;
      if (row >= a.Sq) continue;
      __nv_bfloat16* dst = og + (long long)row * a.os[1];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * t) =
            pack_bf16(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
    }
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

// cuTensorMapEncodeTiled, from the driver through the runtime (libcuda is not linked)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The 4-D (d, S, H, B) map of a bf16 (B, S, H, d) tensor with element strides
// st = (batch, sequence, head), read as boxes of 64 columns x `rows` rows with
// the 128-byte swizzle. Returns 0, or kTmaError + the driver's CUresult.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int d, const long long* st,
             int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kTmaError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  // a dimension of extent 1 is only ever read at 0: give it a stride the driver takes
  const cuuint64_t strides[3] = {S > 1 ? (cuuint64_t)st[1] * 2 : (cuuint64_t)d * 2,
                                 H > 1 ? (cuuint64_t)st[2] * 2 : (cuuint64_t)d * 2,
                                 B > 1 ? (cuuint64_t)st[0] * 2 : (cuuint64_t)d * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaError + (int)r;
}

template <int D>
int launch_wgmma(const Args& a, int B, int Hkv, cudaStream_t stream) {
  using T = Tile<D>;
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, a.q, B, a.Sq, a.Hq, D, a.qs, T::kRows);
  if (!err) err = make_map(&tk, a.k, B, a.Sk, Hkv, D, a.ks, T::kKeys);
  if (!err) err = make_map(&tv, a.v, B, a.Sk, Hkv, D, a.vs, T::kKeys);
  if (err) return err;
  const long long blocks = (long long)B * a.Hq * ((a.Sq + T::kRows - 1) / T::kRows);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  flash_wgmma_bf16<D><<<(unsigned)blocks, kThreads, T::kSmem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, d), k/v (B, Sk, Hkv, d), o (B, Sq, Hq, d), all of `dtype`
// (0 float32, 1 bfloat16) with their last dim contiguous. `strides` holds the
// batch, sequence and head strides of q, k, v and o in that order (12 values,
// in elements). `window` is read when has_window is set. Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does not
// take, kTmaError + a CUresult for a tensor map the driver refused).
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
  if (dtype == 1 && d == 64) return launch_wgmma<64>(a, B, Hkv, st);
  if (dtype == 1 && d == 128) return launch_wgmma<128>(a, B, Hkv, st);
  if (dtype == 1) return (int)launch_rowwise<__nv_bfloat16>(a, d, grid, st);
  if (dtype == 0) return (int)launch_rowwise<float>(a, d, grid, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  if (err >= kTmaError)
    return "cuTensorMapEncodeTiled refused a tensor map (the code less 100000 is its CUresult; "
           "500, not found, when the driver lacks it)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
