// Fused PoNet mixer block for the H100 (sm_90a):
//   out = LayerNorm(x + mixer(x) Wo + bo),  mixer = GA + SMP + LMP
// over the five projections q, k, v, s, l of x, in the float modes (float32,
// bfloat16) and the W8A8 mode (int8 x int8 -> int32, per-row activation and
// per-column weight scales).
//
// Replaces the TPU kernel spokennlp_tpu/ops/pallas/ponet_block.py,
// fused_ponet_mixer_block (_ponet_block_kernel), with its semantics:
//   - every projection rounded to the element type after its float32 bias;
//   - GA: g = masked mean of q (float32 sum, rounded), scores k.g * scale
//     with -1e9 on pad rows, softmax over the sequence, w rounded, gp = sum
//     of w v (float32, rounded), ga = gp * q;
//   - SMP over RUNS: a run starts where the segment id changes (so equal ids
//     that are not adjacent are separate runs); pad rows hold -1e9; each
//     (run, column) gets its max m1 and its strict second max m2 (ties on
//     the max excluded, -1e9 when none), and a row gets m2 where it attains
//     m1 (m1 when m2 is -1e9), else m1;
//   - LMP: the max over offsets -w/2 .. w-1-w/2 with pad rows at -1e9;
//   - mixed = where(mask, (ga + smp) + lmp, 0) in the element type;
//   - the out projection (W8A8: mixed row-quantised), + bias, + x, LayerNorm,
//     all in float32 (bf16_gemm.cuh's and int8_gemm.cuh's residual-LN epilogue).
//
// What bounds it here. At PoNet-base (B=8, L=4096, H=768) the block is six
// (M, H) x (H, H) products, 232 GFLOP, against about 100 MB of input and
// output in float32: bound by arithmetic. Every mode runs its products on
// the tensor cores: float32 on tf32x3_gemm.cuh's 3xTF32 tile (mma.sync TF32,
// each operand split into two TF32 parts, three products a pair: about
// float32's accuracy at a third of the TF32 rate, 165 TFLOP/s against the
// CUDA cores' 67), bf16 on bf16_gemm.cuh's mma.sync bf16 tile, W8A8 on
// int8_gemm.cuh's mma.sync s8 tile (weights K-major). That leaves the
// pooling phases, a few passes over the (M, 5H) projections bound by
// memory, a larger share.
//
// What the design does about the TPU kernel's assumptions. The TPU kernel
// held a whole (L, H) sequence in VMEM per grid step, on a grid of (B,), and
// ran SMP as Hillis-Steele scans of sublane rolls. A Hopper SM has 227 KB of
// shared memory (one float32 projection of one sequence is 12.6 MB) and a
// grid of 8 blocks would leave most of the 132 SMs idle, so the block is a
// chain of launches behind one C entry, each spread over many blocks:
//   1. the five projections as ONE (M, H) x (H, 5H) GEMM into an (M, 5H)
//      buffer of the element type (W8A8: x row-quantised once, shared);
//   2. GA in five launches: the masked column sums of q over 128-row
//      chunks (each chunk's sum in row order, a thread owning 16 bytes of
//      adjacent columns), g from the chunks' sums in chunk order, the
//      scores (a warp a row), the softmax's maximum and sums (one block a
//      warp of the 256-thread order of its sum), and the weighted column
//      sums of v (the weights formed in the launch); GA's pooled value gp
//      is finished in step 3's scan;
//   3+4. SMP, LMP and the mix in three launches over 64-row tiles: the
//      tiles' summaries (a thread owning a tile's 16 bytes of adjacent
//      columns: the top-2 of the tile's first and last run fragments; pad
//      rows' s is not read: their -1e9 is the combine's floor), a scan over
//      them a (sequence, column) in O(tiles) whatever the runs (from_left,
//      the run's rows before a tile, and from_right, after it), and the mix:
//      the tile's s staged in shared memory by cp.async, a thread a column
//      walks its runs there (completing the first and last with the scan's
//      summaries) and leaves each row's SMP value there, then the block
//      streams the rows, reading q and l once and writing mixed once. The
//      top-2 combine takes maxima only, so the order of combines does not
//      move a bit;
//   5. the out projection with the residual-LayerNorm epilogue of kernels 1
//      and 2 (W8A8: one row-quant launch of mixed first).
// Steps 1 and 5 take bf16_gemm.cuh's launchers in both float modes (float32
// on tf32x3_gemm.cuh's tile).
// Nothing is atomic: every sum is taken in the same order on every run.
#include "int8_gemm.cuh"

namespace spk {
namespace {

constexpr int kGaRows = 128;            // rows of one partial column sum of GA
constexpr int kSmpRows = 64;            // rows of one SMP tile
constexpr int kGaWarps = kThreads / 32;  // the softmax sum's warp partials

// The (max, strict second max) summary of a multiset, -1e9 when empty; the
// combine of ponet_block.py _top2_combine. It is a function of the set of
// values alone (max and comparisons, no rounding), so every grouping and
// order of combines gives the same bits; {-inf, -inf} is its identity.
struct Top2 {
  float m1, m2;
};

__device__ __forceinline__ Top2 top2_combine(Top2 p, Top2 c) {
  const float nm1 = fmaxf(p.m1, c.m1);
  const float cp = p.m1 < nm1 ? p.m1 : p.m2;
  const float cc = c.m1 < nm1 ? c.m1 : c.m2;
  return {nm1, fmaxf(cp, cc)};
}

__device__ __forceinline__ Top2 top2_of(float v) { return {v, kNegInf}; }

__device__ __forceinline__ Top2 top2_none() { return {-CUDART_INF_F, -CUDART_INF_F}; }

// VEC adjacent columns of a row in one 16- or 8-byte access (bf16: 8 or 4,
// float32: 4 or 2), where every row starts on such a boundary (H a multiple
// of VEC), else VEC = 1. load_raw reads them as stored (so that a walk can
// put many reads in flight before it uses them), unpack widens them to
// float32, store_vec narrows and writes values of T.
template <typename T, int VEC>
using Raw = std::conditional_t<VEC == 1, T,
                               std::conditional_t<VEC * sizeof(T) == 16, uint4, uint2>>;

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* p) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16 || VEC * sizeof(T) == 8, "8 or 16 bytes");
  if constexpr (VEC == 1) {
    return *p;
  } else {
    return *reinterpret_cast<const Raw<T, VEC>*>(p);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& u, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(u);
  } else if constexpr (std::is_same<T, float>::value) {
    const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = f[i];
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  unpack<T, VEC>(load_raw<T, VEC>(p), v);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f32<T>(v[0]);
  } else {
    Raw<T, VEC> u;
    if constexpr (std::is_same<T, float>::value) {
      float* f = reinterpret_cast<float*>(&u);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = v[i];
    } else {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<Raw<T, VEC>*>(p) = u;
  }
}

// VEC adjacent Top2 summaries stored (8 VEC bytes, 16-byte aligned when VEC > 1)
template <int VEC>
__device__ __forceinline__ void store_top2(Top2* p, const Top2 (&t)[VEC]) {
  if constexpr (VEC == 1) {
    *p = t[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(t[2 * i].m1, t[2 * i].m2, t[2 * i + 1].m1,
                                                    t[2 * i + 1].m2);
  }
}

// GA's per-sequence numbers of one call, a float32 row of ga_stats_floats(nch)
// a sequence: the mask's count of each 128-row chunk, the softmax sum's warp
// partials, then the scores' maximum.
__host__ __device__ constexpr int ga_stats_floats(int nch) { return nch + kGaWarps + 1; }

// partial[(b * nch + c) * H + h] = sum over the rows l of chunk c of
// src[(b L + l) ld + h] * weight, in row order, VEC columns a thread. The
// weight is (mask > 0) without att (the chunk's mask count then goes to
// stats), else the softmax weight round_T(exp(att - m) / s) of the row,
// from the sequence's m and warp partials in stats (the softmax's last
// step, folded in). Grid (ceil(H / (VEC blockDim)), nch, B).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ga_partial_kernel(const T* __restrict__ src, int ld, const int* __restrict__ mask,
                      const float* __restrict__ att, float* __restrict__ stats,
                      float* __restrict__ partial, int L, int H) {
  __shared__ float wts[kGaRows];
  const int c = blockIdx.y, b = blockIdx.z, nch = gridDim.y;
  const int l0 = c * kGaRows, n = min(L, l0 + kGaRows) - l0;
  float* st = stats + (size_t)b * ga_stats_floats(nch);
  if (att == nullptr) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      wts[i] = mask[(size_t)b * L + l0 + i] > 0 ? 1.0f : 0.0f;
  } else {
    const float m = st[nch + kGaWarps];
    float s = 0.0f;
    for (int w = 0; w < kGaWarps; ++w) s += st[nch + w];
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      wts[i] = round_to<T>(expf(att[(size_t)b * L + l0 + i] - m) / s);
  }
  __syncthreads();
  if (att == nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    float cnt = 0.0f;  // an integer: exact in any order
    for (int i = 0; i < n; ++i) cnt += wts[i];
    st[c] = cnt;
  }
  const int h = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (h >= H) return;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  const T* p = src + ((size_t)b * L + l0) * ld + h;
  constexpr int U = 16;  // rows read ahead
  for (int i0 = 0; i0 < n; i0 += U) {
    Raw<T, VEC> r[U];
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (i0 + i < n) r[i] = load_raw<T, VEC>(p + (size_t)(i0 + i) * ld);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (i0 + i >= n) break;
      float x[VEC];
      unpack<T, VEC>(r[i], x);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(x[j], wts[i0 + i]));
    }
  }
  float* out = partial + ((size_t)b * nch + c) * H + h;
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = acc[j];
}

// GA's pooled query: g[b H + h] = round_T(sum over chunks of partial /
// max(count, 1)), the chunks' sums and counts taken in chunk order. Grid
// (ceil(H / kThreads), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ga_finish_kernel(const float* __restrict__ partial, const float* __restrict__ stats, int nch,
                     int H, float* __restrict__ g) {
  const int b = blockIdx.y, h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  const float* st = stats + (size_t)b * ga_stats_floats(nch);
  float n = 0.0f;
  for (int i = 0; i < nch; ++i) n += st[i];
  float s = 0.0f;
#pragma unroll 8
  for (int i = 0; i < nch; ++i) s = __fadd_rn(s, partial[((size_t)b * nch + i) * H + h]);
  g[(size_t)b * H + h] = round_to<T>(s / fmaxf(n, 1.0f));
}

// GA's scores: att[row] = (k[row] . g) * sm_scale + (mask ? 0 : -1e9), a
// warp a row, lane j summing columns j, j + 32, ... in order, then
// warp_sum. k is the second projection of the (M, 5H) buffer, g ga_finish's
// (B, H). Grid ceil(B L / 8), 256 threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ga_scores_kernel(const T* __restrict__ proj, const float* __restrict__ g,
                     const int* __restrict__ mask, float* __restrict__ att, int B, int L, int H,
                     float sm_scale) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= B * L) return;
  const int b = row / L;
  const T* k = proj + (size_t)row * 5 * H + H;
  float s = 0.0f;
  for (int h = lane; h < H; h += 32)
    s = __fadd_rn(s, __fmul_rn(to_f32(k[h]), g[(size_t)b * H + h]));
  s = warp_sum(s);
  if (lane == 0) att[row] = __fadd_rn(__fmul_rn(s, sm_scale), mask[row] > 0 ? 0.0f : kNegInf);
}

// The softmax over the L scores of sequence b: its maximum m (every block
// takes it over the whole sequence) and the warp partials of sum exp(att -
// m), each of one warp of a 256-thread walk, thread t taking rows t, t +
// 256, ... in order then warp_sum (one 256-thread block's sum over the
// sequence, spread over one block a warp); ga_partial_kernel adds the
// partials in warp order and forms the weights. Grid (kGaWarps, B), 32
// threads.
__global__ void __launch_bounds__(32)
    ga_softmax_kernel(const float* __restrict__ att, float* __restrict__ stats, int L, int nch) {
  const int w = blockIdx.x, b = blockIdx.y, tid = 32 * w + threadIdx.x;
  float* st = stats + (size_t)b * ga_stats_floats(nch);
  const float* a = att + (size_t)b * L;
  float m = -CUDART_INF_F;
#pragma unroll 8
  for (int l = threadIdx.x; l < L; l += 32) m = fmaxf(m, a[l]);
  m = warp_max(m);
  float s = 0.0f;
  for (int l = tid; l < L; l += kThreads) s += expf(a[l] - m);
  s = warp_sum(s);
  if (threadIdx.x == 0) {
    st[nch + w] = s;
    if (w == 0) st[nch + kGaWarps] = m;
  }
}

// What the SMP passes read: the (M, 5H) projections (q at column 0, s at 3H,
// l at 4H), the mask, gp (B, H) and the pooling window.
template <typename T>
struct MixArgs {
  const T* proj;
  const int* mask;
  const float* gp;
  T* mixed;
  int L, H, window;
};

// Tile flags: bit 0 a run starts inside (t0, t1), bit 1 at t0, bit 2 at t1.
constexpr int kStartInside = 1, kStartAtFirst = 2, kStartAtEnd = 4;

// The run starts of the tile's rows t0 .. t1 (t1 included: a row starts a
// run when it is the first, the end of the sequence, or its id differs from
// the previous row's) into starts (n + 1 flags) and the mask of rows t0 -
// lo .. t1 + hi - 1 (0 outside the sequence) into live; returns the tile's
// flags.
__device__ __forceinline__ int load_tile(const int* seg, const int* mask, int b, int L, int t0,
                                         int t1, int lo, int hi, int* starts, int* live) {
  for (int i = threadIdx.x; i <= t1 - t0; i += blockDim.x) {
    const int l = t0 + i;
    starts[i] = (l == 0 || l == L || seg[(size_t)b * L + l] != seg[(size_t)b * L + l - 1]) ? 1 : 0;
  }
  for (int i = threadIdx.x; i < t1 - t0 + lo + hi; i += blockDim.x) {
    const int l = t0 - lo + i;
    live[i] = l >= 0 && l < L && mask[(size_t)b * L + l] > 0 ? 1 : 0;
  }
  __syncthreads();
  const int n = t1 - t0;
  int inside = 0;
  for (int i = 1; i < n; ++i) inside |= starts[i];
  return (inside ? kStartInside : 0) | (starts[0] ? kStartAtFirst : 0) |
         (starts[n] ? kStartAtEnd : 0);
}

// The thread's walk over its tile's rows in order, VEC columns at h: each
// run fragment's top-2 summary of SMP's values (the s projection, -1e9 on
// pad rows, whose s is not read), passed to done(fs, l, acc) as the
// fragment [fs, l) ends. s rows are read eight at a time, so eight 16-byte
// loads are in flight.
template <typename T, int VEC, typename Done>
__device__ __forceinline__ void walk_fragments(const MixArgs<T>& a, int b, int t0, int t1,
                                               int h, const int* starts, const int* live,
                                               Done done) {
  const size_t ld = 5 * (size_t)a.H;
  const T* s = a.proj + (size_t)b * a.L * ld + 3 * a.H + h;
  Top2 acc[VEC];
  int fs = t0;
  for (int l0 = t0; l0 < t1; l0 += 8) {
    Raw<T, VEC> r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (l0 + j < t1 && live[l0 + j - t0]) r[j] = load_raw<T, VEC>(s + (size_t)(l0 + j) * ld);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int l = l0 + j;
      if (l >= t1) break;
      if (l > t0 && starts[l - t0]) {
        done(fs, l, acc);
        fs = l;
      }
      float x[VEC];
      if (live[l - t0]) {
        unpack<T, VEC>(r[j], x);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[v] = kNegInf;
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[v] = l == fs ? top2_of(x[v]) : top2_combine(acc[v], top2_of(x[v]));
    }
  }
  done(fs, t1, acc);
}

// SMP pass 1. Grid (ceil(H / (VEC blockDim)), ceil(L / kSmpRows), B): a
// thread per (tile, VEC columns) writes the summaries of the tile's first
// and last run fragments (first, last: (B, tiles, H)); one thread writes
// the tile's flags.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    smp_tiles_kernel(MixArgs<T> a, const int* __restrict__ seg, Top2* __restrict__ first,
                     Top2* __restrict__ last, int* __restrict__ flags) {
  __shared__ int starts[kSmpRows + 1], live[kSmpRows];
  const int tile = blockIdx.y, b = blockIdx.z, tiles = gridDim.y;
  const int t0 = tile * kSmpRows, t1 = min(a.L, t0 + kSmpRows);
  const int f = load_tile(seg, a.mask, b, a.L, t0, t1, 0, 0, starts, live);
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[(size_t)b * tiles + tile] = f;
  const int h = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (h >= a.H) return;
  const size_t slot = ((size_t)b * tiles + tile) * a.H + h;
  walk_fragments<T, VEC>(a, b, t0, t1, h, starts, live,
                         [&](int fs, int l, const Top2(&acc)[VEC]) {
                           if (fs == t0) store_top2<VEC>(first + slot, acc);
                           if (l == t1) store_top2<VEC>(last + slot, acc);
                         });
}

// SMP's scan over the tiles, in place, a thread per (sequence, column): last
// becomes from_left, the summary of the rows before the tile in the run of
// its first row, and first becomes from_right, that of the rows after the
// tile in the run of its last row ({-inf, -inf} where there are none). O(tiles)
// a column, whatever the runs. Also gp[b H + h] = round_T(sum over chunks
// of GA's second partials) (ga_finish, folded in). Grid (ceil(H / kThreads),
// B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    smp_scan_kernel(Top2* __restrict__ first, Top2* __restrict__ last,
                    const int* __restrict__ flags, const float* __restrict__ partial, int nch,
                    float* __restrict__ gp, int tiles, int H) {
  const int h = blockIdx.x * kThreads + threadIdx.x, b = blockIdx.y;
  if (h >= H) return;
  float s = 0.0f;
#pragma unroll 8
  for (int c = 0; c < nch; ++c) s = __fadd_rn(s, partial[((size_t)b * nch + c) * H + h]);
  gp[(size_t)b * H + h] = round_to<T>(s);
  const int* fl = flags + (size_t)b * tiles;
  Top2* lst = last + (size_t)b * tiles * H + h;
  Top2* fst = first + (size_t)b * tiles * H + h;
  constexpr int U = 8;  // tiles read ahead
  Top2 carry = top2_none();
  for (int t0 = 0; t0 < tiles; t0 += U) {
    Top2 v[U];
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (t0 + j < tiles) v[j] = lst[(size_t)(t0 + j) * H];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int t = t0 + j;
      if (t >= tiles) break;
      lst[(size_t)t * H] = carry;
      carry = fl[t] & (kStartInside | kStartAtFirst) ? v[j] : top2_combine(carry, v[j]);
    }
  }
  carry = top2_none();
  for (int t0 = tiles - 1; t0 >= 0; t0 -= U) {
    Top2 v[U];
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (t0 - j >= 0) v[j] = fst[(size_t)(t0 - j) * H];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int t = t0 - j;
      if (t < 0) break;
      fst[(size_t)t * H] = carry;
      carry = fl[t] & (kStartInside | kStartAtEnd) ? v[j] : top2_combine(v[j], carry);
    }
  }
}

// The mix's block: kMixCols columns of a 64-row tile, a thread each in its
// walk; its rows streamed kMixRows at a time, whose l rows are read
// together for windows up to kMaxBatchWindow (a wider window's a row at a
// time).
constexpr int kMixCols = 128, kMixRows = 4, kMaxBatchWindow = 4;

// float32 writes the rows' SMP values over their s, which its walk has read
// (so that more blocks fit an SM); bf16 beside them
template <typename T>
__host__ __device__ constexpr size_t mix_smem_bytes(int window) {
  constexpr bool in_place = std::is_same<T, float>::value;
  return (size_t)kSmpRows * kMixCols * (sizeof(T) + (in_place ? 0 : sizeof(float))) +
         (size_t)(2 * kSmpRows + window) * sizeof(int);
}

// SMP pass 2, LMP and the mix. Grid (ceil(H / kMixCols), ceil(L / kSmpRows),
// B), kMixCols threads, mix_smem_bytes<T>(window) of dynamic shared memory:
//   1. the tile's s rows of the block's columns into shared memory
//      (cp.async, 16 bytes a copy where rows allow; pad rows not read);
//   2. a thread a column walks them: each run fragment's top-2, the first
//      completed by from_left and the last by from_right where their run
//      crosses the tile's edges (the scan's), then each row's SMP value
//      into shared memory (float32), while the reads of step 3's first rows
//      are in flight;
//   3. the block streams the tile's rows, VEC columns a thread: q and the l
//      rows of the window read once a row batch (16 bytes each), mixed =
//      where(mask, (ga + smp) + lmp, 0) rounded to T after each sum as the
//      TPU kernel rounds, ga = round_T(gp * q), LMP the max of l over the
//      window's rows (pad rows and rows outside the sequence at
//      round_T(-1e9)), written once.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMixCols)
    smp_mix_kernel(MixArgs<T> a, const int* __restrict__ seg, const Top2* __restrict__ from_right,
                   const Top2* __restrict__ from_left) {
  extern __shared__ __align__(16) unsigned char mix_smem[];
  constexpr bool in_place = std::is_same<T, float>::value;
  T* s_tile = reinterpret_cast<T*>(mix_smem);  // (kSmpRows, kMixCols)
  float* smp = reinterpret_cast<float*>(
      mix_smem + (in_place ? 0 : (size_t)kSmpRows * kMixCols * sizeof(T)));
  int* starts = reinterpret_cast<int*>(smp + kSmpRows * kMixCols);
  int* live = starts + kSmpRows + 1;
  const int tile = blockIdx.y, b = blockIdx.z, tiles = gridDim.y, L = a.L, H = a.H;
  const int t0 = tile * kSmpRows, t1 = min(L, t0 + kSmpRows), n = t1 - t0;
  const int lo = a.window / 2, hi = a.window - 1 - lo, w = a.window;
  const int c0 = blockIdx.x * kMixCols, nc = min(kMixCols, H - c0);
  const size_t ld = 5 * (size_t)H;
  const T* rows = a.proj + ((size_t)b * L + t0) * ld + c0;  // the tile's first row, q at 0
  load_tile(seg, a.mask, b, L, t0, t1, lo, hi, starts, live);
  const int* live_t = live + lo;  // live_t[r]: row t0 + r, r in [-lo, n + hi)

  // step 3's thread: VEC columns at col of its RPT rows from r_first
  constexpr int NV = kMixCols / VEC, RG = kMixCols / NV, RPT = kSmpRows / RG;
  constexpr int NL = kMixRows + kMaxBatchWindow - 1;
  const int col = threadIdx.x % NV * VEC, r_first = threadIdx.x / NV * RPT;
  const bool mixes = col < nc, batch = w <= kMaxBatchWindow;
  const T* q_rows = rows + col;
  const T* l_rows = rows + 4 * H + col;
  // q of a batch's rows and l of the rows their windows reach (row r0 + k -
  // lo in lr[k]), read before any is used
  Raw<T, VEC> qr[kMixRows], lr[NL];
  const auto l_live = [&](int r0, int k) {  // lr[k] holds a real row
    return k < kMixRows + w - 1 && r0 + k - lo < n + hi && live_t[r0 + k - lo];
  };
  const auto load_batch = [&](int r0) {
#pragma unroll
    for (int i = 0; i < kMixRows; ++i)
      if (r0 + i < n && live_t[r0 + i]) qr[i] = load_raw<T, VEC>(q_rows + (size_t)(r0 + i) * ld);
    if (batch) {
#pragma unroll
      for (int k = 0; k < NL; ++k)
        if (l_live(r0, k))
          lr[k] = load_raw<T, VEC>(l_rows + (ptrdiff_t)(r0 + k - lo) * (ptrdiff_t)ld);
    }
  };

  // 1. s of the tile's rows; step 3's first reads in flight beside them
  if constexpr (VEC > 1) {
    constexpr int PR = kMixCols / VEC;  // copies a row
    for (int e = threadIdx.x; e < n * PR; e += kMixCols) {
      const int r = e / PR, c = e % PR * VEC;
      const bool in = c < nc && live_t[r];
      cp_async16(smem_addr(s_tile + r * kMixCols + c),
                 in ? rows + (size_t)r * ld + 3 * H + c : rows, in ? 16 : 0);
    }
    cp_async_commit();
  } else {
    for (int e = threadIdx.x; e < n * kMixCols; e += kMixCols) {
      const int r = e / kMixCols, c = e % kMixCols;
      if (c < nc && live_t[r]) s_tile[e] = rows[(size_t)r * ld + 3 * H + c];
    }
  }
  if (mixes && r_first < n) load_batch(r_first);
  float gp[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) gp[v] = mixes ? a.gp[(size_t)b * H + c0 + col + v] : 0.0f;
  if constexpr (VEC > 1) cp_async_wait<0>();
  __syncthreads();

  // 2. each column's run summaries, then its rows' SMP values
  if (threadIdx.x < nc) {
    const int c = threadIdx.x;
    const size_t slot = ((size_t)b * tiles + tile) * H + c0 + c;
    const auto value = [&](int r) {
      return live_t[r] ? to_f32(s_tile[r * kMixCols + c]) : kNegInf;
    };
    Top2 acc = top2_of(value(0));
    int fs = 0;
    for (int i = 1; i <= n; ++i) {
      if (i < n && !starts[i]) {
        acc = top2_combine(acc, top2_of(value(i)));
        continue;
      }
      // the fragment [fs, i) ends here
      Top2 run = acc;
      if (fs == 0 && !starts[0]) run = top2_combine(from_left[slot], run);
      if (i == n && !starts[n]) run = top2_combine(run, from_right[slot]);
      const float tok_m2 = run.m2 <= 0.5f * kNegInf ? run.m1 : run.m2;
      for (int r = fs; r < i; ++r) {
        const float x = value(r);  // read before its slot is written in place
        smp[r * kMixCols + c] = x >= run.m1 ? tok_m2 : run.m1;
      }
      if (i < n) {
        fs = i;
        acc = top2_of(value(i));
      }
    }
  }
  __syncthreads();

  // 3. the mix, its rows kMixRows at a time
  if (!mixes) return;
  const float neg = round_to<T>(kNegInf);
  for (int r0 = r_first; r0 < r_first + RPT && r0 < n; r0 += kMixRows) {
    if (r0 != r_first) load_batch(r0);
#pragma unroll
    for (int i = 0; i < kMixRows; ++i) {
      const int r = r0 + i;
      if (r >= n) break;
      float out[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) out[v] = 0.0f;
      if (live_t[r]) {
        float q[VEC], lmp[VEC];
        unpack<T, VEC>(qr[i], q);
#pragma unroll
        for (int v = 0; v < VEC; ++v) lmp[v] = neg;
        if (batch) {
#pragma unroll
          for (int o = 0; o < kMaxBatchWindow; ++o) {
            if (o >= w || !l_live(r0, i + o)) continue;  // a pad row's value is neg
            float y[VEC];
            unpack<T, VEC>(lr[i + o], y);
#pragma unroll
            for (int v = 0; v < VEC; ++v) lmp[v] = fmaxf(lmp[v], y[v]);
          }
        } else {
          for (int o = 0; o < w; ++o) {
            if (r + o - lo >= n + hi || !live_t[r + o - lo]) continue;
            float y[VEC];
            load_vec<T, VEC>(l_rows + (ptrdiff_t)(r + o - lo) * (ptrdiff_t)ld, y);
#pragma unroll
            for (int v = 0; v < VEC; ++v) lmp[v] = fmaxf(lmp[v], y[v]);
          }
        }
        const float* sm = smp + r * kMixCols + col;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float ga = round_to<T>(__fmul_rn(gp[v], q[v]));
          out[v] = round_to<T>(__fadd_rn(round_to<T>(__fadd_rn(ga, sm[v])), lmp[v]));
        }
      }
      store_vec<T, VEC>(a.mixed + ((size_t)b * L + t0 + r) * H + c0 + col, out);
    }
  }
}

// The scratch of one call; see spk_ponet_block.
template <typename T>
struct Scratch {
  T* proj;         // (M, 5H)
  float* partial;  // (B, ceil(L / kGaRows), H)
  float* stats;    // (B, ga_stats_floats(ceil(L / kGaRows))): GA's counts, sums, maximum
  float* att;      // (B, L): GA's scores
  float* gp;       // (B, H): GA's g, then its pooled value gp
  T* mixed;        // (M, H)
  Top2* first;     // (B, ceil(L / kSmpRows), H): first fragments, then from_right
  Top2* last;      // (B, ceil(L / kSmpRows), H): last fragments, then from_left
  int* flags;      // (B, ceil(L / kSmpRows))
  int8_t* x8;      // (M, H), W8A8 only
  float* scales;   // (M), W8A8 only
  float* rows;     // (M, H) pre-norm rows of the epilogue
};

// Threads a block and blocks across the columns of a launch with VEC
// columns a thread: up to kThreads, a multiple of 32.
inline dim3 column_blocks(int H, int vec, int& vt) {
  const int nvec = (H + vec - 1) / vec;
  vt = nvec >= kThreads ? kThreads : (nvec + 31) / 32 * 32;
  return dim3((nvec + vt - 1) / vt);
}

// Steps 2-4 of ponet_block (GA, SMP, LMP and the mix) with VEC columns a
// thread: 8 launches.
template <typename T, int VEC>
cudaError_t pooling_chain(const int* mask, const int* seg, const Scratch<T>& s, int B, int L,
                          int H, int window, float sm_scale, cudaStream_t stream) {
  const int nch = (L + kGaRows - 1) / kGaRows, tiles = (L + kSmpRows - 1) / kSmpRows;
  int vt;
  const int nx = column_blocks(H, VEC, vt).x;
  // 2. GA: the masked column sums of q, g (into gp's buffer, which step 3's
  // scan overwrites), the scores, the softmax's maximum and sums, the
  // weighted column sums of v (the weights folded in)
  ga_partial_kernel<T, VEC><<<dim3(nx, nch, B), vt, 0, stream>>>(s.proj, 5 * H, mask, nullptr,
                                                                  s.stats, s.partial, L, H);
  ga_finish_kernel<T><<<dim3((H + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
      s.partial, s.stats, nch, H, s.gp);
  const int M = B * L, wpb = kThreads / 32;
  ga_scores_kernel<T><<<(M + wpb - 1) / wpb, kThreads, 0, stream>>>(s.proj, s.gp, mask, s.att, B,
                                                                    L, H, sm_scale);
  ga_softmax_kernel<<<dim3(kGaWarps, B), 32, 0, stream>>>(s.att, s.stats, L, nch);
  ga_partial_kernel<T, VEC><<<dim3(nx, nch, B), vt, 0, stream>>>(s.proj + 2 * H, 5 * H, mask,
                                                                  s.att, s.stats, s.partial, L, H);
  // 3 + 4. SMP's tile summaries, their scan (and gp), then LMP and the mix
  const MixArgs<T> args{s.proj, mask, s.gp, s.mixed, L, H, window};
  const dim3 grid(nx, tiles, B);
  smp_tiles_kernel<T, VEC><<<grid, vt, 0, stream>>>(args, seg, s.first, s.last, s.flags);
  smp_scan_kernel<T><<<dim3((H + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
      s.first, s.last, s.flags, s.partial, nch, s.gp, tiles, H);
  const size_t msmem = mix_smem_bytes<T>(window);
  const cudaError_t err = prepare(smp_mix_kernel<T, VEC>, msmem);
  if (err != cudaSuccess) return err;
  smp_mix_kernel<T, VEC><<<dim3((H + kMixCols - 1) / kMixCols, tiles, B), kMixCols, msmem,
                           stream>>>(args, seg, s.first, s.last);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ponet_block(int quantized, const T* x, const int* mask, const int* seg,
                        const void* wp, const float* swp, const float* bp, const void* wo,
                        const float* swo, const float* bo, const float* ln_scale,
                        const float* ln_bias, const Scratch<T>& s, T* out, int B, int L, int H,
                        int window, int fuse_ln, float sm_scale, float eps, cudaStream_t stream) {
  const int M = B * L;
  cudaError_t err;
  // 1. the five projections, one GEMM
  if (quantized) {
    err = launch_rowquant<T>(x, M, H, 1, s.x8, s.scales, stream);
    if (err != cudaSuccess) return err;
    err = launch_gemm_i8<T>(s.x8, s.scales, static_cast<const int8_t*>(wp), swp, bp, s.proj, M,
                            5 * H, H, kActNone, stream);
  } else {
    err = launch_gemm<T>(x, static_cast<const T*>(wp), bp, s.proj, M, 5 * H, H, kActNone, nullptr,
                         stream);
  }
  if (err != cudaSuccess) return err;
  // 2-4. GA, SMP, LMP and the mix: 16-byte columns a thread where the rows
  // allow
  constexpr int kVec = 16 / sizeof(T);
  err = H % kVec == 0 ? pooling_chain<T, kVec>(mask, seg, s, B, L, H, window, sm_scale, stream)
                      : pooling_chain<T, 1>(mask, seg, s, B, L, H, window, sm_scale, stream);
  if (err != cudaSuccess) return err;
  // 5. the out projection, residual and LayerNorm
  if (quantized) {
    err = launch_rowquant<T>(s.mixed, M, H, 1, s.x8, s.scales, stream);
    if (err != cudaSuccess) return err;
    return launch_residual_ln_i8<T>(s.x8, s.scales, static_cast<const int8_t*>(wo), swo, bo, x,
                                    ln_scale, ln_bias, s.rows, out, M, H, H, 1, eps, fuse_ln,
                                    stream);
  }
  return launch_residual_ln<T>(s.mixed, static_cast<const T*>(wo), bo, x, ln_scale, ln_bias,
                               s.rows, out, M, H, H, eps, fuse_ln, stream);
}

template <typename T>
int ponet_block_entry(int quantized, const void* x, const void* mask, const void* seg,
                      const void* wp, const void* swp, const void* bp, const void* wo,
                      const void* swo, const void* bo, const void* ln_scale, const void* ln_bias,
                      void* proj, void* partial, void* stats, void* att, void* gp, void* mixed,
                      void* first, void* last, void* flags, void* x8, void* scales, void* rows,
                      void* out, int B, int L, int H, int window, int fuse_ln, float sm_scale,
                      float eps, void* stream) {
  const Scratch<T> s{static_cast<T*>(proj),      static_cast<float*>(partial),
                     static_cast<float*>(stats), static_cast<float*>(att),
                     static_cast<float*>(gp),    static_cast<T*>(mixed),
                     static_cast<Top2*>(first),  static_cast<Top2*>(last),
                     static_cast<int*>(flags),   static_cast<int8_t*>(x8),
                     static_cast<float*>(scales), static_cast<float*>(rows)};
  return static_cast<int>(ponet_block<T>(
      quantized, static_cast<const T*>(x), static_cast<const int*>(mask),
      static_cast<const int*>(seg), wp, static_cast<const float*>(swp),
      static_cast<const float*>(bp), wo, static_cast<const float*>(swo),
      static_cast<const float*>(bo), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), s, static_cast<T*>(out), B, L, H, window, fuse_ln,
      sm_scale, eps, static_cast<cudaStream_t>(stream)));
}

}  // namespace
}  // namespace spk

// dtype: 0 = float32, 1 = bfloat16 (x, out, and the proj and mixed scratch).
// x (B, L, H); mask and seg (B, L) int32. Float modes: wp (H, 5H) the five
// projections side by side and wo (H, H) in the element type, swp and swo
// null. W8A8 (quantized = 1): wp (5H, H) and wo (H, H) int8, K-major (the
// float layouts transposed), with per-column scales swp (5H) and swo (H).
// bp (5H), bo (H), ln_scale and ln_bias (H) are
// float32; fuse_ln = 0 returns the projection alone (no residual, no
// LayerNorm). Scratch as in Scratch above; x8 and scales may be null in the
// float modes. Returns the first CUDA error, or 0.
extern "C" int spk_ponet_block(int dtype, int quantized, const void* x, const void* mask,
                               const void* seg, const void* wp, const void* swp, const void* bp,
                               const void* wo, const void* swo, const void* bo,
                               const void* ln_scale, const void* ln_bias, void* proj,
                               void* partial, void* stats, void* att, void* gp, void* mixed,
                               void* first, void* last, void* flags, void* x8, void* scales,
                               void* rows, void* out, int B, int L, int H, int window, int fuse_ln,
                               float sm_scale, float eps, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || window <= 0 || (quantized && H % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return spk::ponet_block_entry<float>(quantized, x, mask, seg, wp, swp, bp, wo, swo, bo,
                                         ln_scale, ln_bias, proj, partial, stats, att, gp, mixed,
                                         first, last, flags, x8, scales, rows, out, B, L, H,
                                         window, fuse_ln, sm_scale, eps, stream);
  if (dtype == 1)
    return spk::ponet_block_entry<__nv_bfloat16>(quantized, x, mask, seg, wp, swp, bp, wo, swo,
                                                 bo, ln_scale, ln_bias, proj, partial, stats, att,
                                                 gp, mixed, first, last, flags, x8, scales, rows,
                                                 out, B, L, H, window, fuse_ln, sm_scale, eps,
                                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
