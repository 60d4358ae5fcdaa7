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
//   2. GA's two column reductions over L in two passes each (partial sums
//      of 128-row chunks in a fixed order, then their sum), a warp per row
//      for the scores, one block per sequence for the softmax;
//   3+4. SMP, LMP and the mix in two passes over 64-row tiles, a thread per
//      (tile, column): the first pass finishes every run that starts and
//      ends inside its tile and writes the top-2 summary of the tile's first
//      and last run fragments; the second pass completes the fragments that
//      cross a tile edge by walking the neighbouring tiles' summaries (a
//      tile that holds no run start is all one run, so the walk goes on past
//      it), then writes their rows. Each row is mixed (GA, SMP, LMP) where
//      its run is finished, and written once;
//   5. the out projection with the residual-LayerNorm epilogue of kernels 1
//      and 2 (W8A8: one row-quant launch of mixed first).
// Steps 1 and 5 take bf16_gemm.cuh's launchers in both float modes (float32
// on tf32x3_gemm.cuh's tile).
// Nothing is atomic: every sum is taken in the same order on every run.
#include "int8_gemm.cuh"

namespace spk {
namespace {

constexpr int kGaRows = 128;   // rows of one partial column sum of GA
constexpr int kSmpRows = 64;   // rows of one SMP tile
constexpr int kCols = kThreads;  // columns of one GA / SMP block: a thread each

// The (max, strict second max) summary of a multiset, -1e9 when empty; the
// combine of ponet_block.py _top2_combine.
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

// partial[(b * nch + c) * H + h] = sum over the rows l of chunk c of
// src[(b L + l) ld + h] * weight, weight = wts[b L + l], or (mask > 0) when
// wts is null. Grid (ceil(H / kCols), nch, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ga_partial_kernel(const T* __restrict__ src, int ld, const int* __restrict__ mask,
                      const float* __restrict__ wts, float* __restrict__ partial, int L, int H) {
  const int h = blockIdx.x * kCols + threadIdx.x, c = blockIdx.y, b = blockIdx.z;
  if (h >= H) return;
  const int l1 = min(L, (c + 1) * kGaRows);
  float s = 0.0f;
  for (int l = c * kGaRows; l < l1; ++l) {
    const size_t row = (size_t)b * L + l;
    const float w = wts != nullptr ? wts[row] : (mask[row] > 0 ? 1.0f : 0.0f);
    s = __fadd_rn(s, __fmul_rn(to_f32(src[row * ld + h]), w));
  }
  partial[((size_t)b * gridDim.y + c) * H + h] = s;
}

// out[b H + h] = round_T(sum over chunks of partial / denom), denom = max(sum
// of the mask of sequence b, 1) when mask is given, else 1. Grid
// (ceil(H / kCols), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ga_finish_kernel(const float* __restrict__ partial, int nch, const int* __restrict__ mask,
                     int L, int H, float* __restrict__ out) {
  __shared__ float warp_part[kThreads / 32];
  const int b = blockIdx.y;
  float denom = 1.0f;
  if (mask != nullptr) {
    float n = 0.0f;
    for (int l = threadIdx.x; l < L; l += kThreads) n += mask[(size_t)b * L + l] > 0 ? 1.0f : 0.0f;
    n = warp_sum(n);
    if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = n;
    __syncthreads();
    n = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) n += warp_part[w];
    denom = fmaxf(n, 1.0f);
  }
  const int h = blockIdx.x * kCols + threadIdx.x;
  if (h >= H) return;
  float s = 0.0f;
  for (int c = 0; c < nch; ++c) s = __fadd_rn(s, partial[((size_t)b * nch + c) * H + h]);
  out[(size_t)b * H + h] = round_to<T>(s / denom);
}

// att[row] = (k[row] . g[b]) * sm_scale + (mask ? 0 : -1e9), one warp a row;
// k is the second projection of the (M, 5H) buffer. Grid (ceil(M / 8)).
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

// The softmax over the L scores of sequence b, in place: w = round_T(exp(att
// - max) / sum). Grid (B).
template <typename T>
__global__ void __launch_bounds__(kThreads) ga_softmax_kernel(float* __restrict__ att, int L) {
  __shared__ float warp_part[kThreads / 32];
  float* a = att + (size_t)blockIdx.x * L;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float m = -CUDART_INF_F;
  for (int l = threadIdx.x; l < L; l += kThreads) m = fmaxf(m, a[l]);
  m = warp_max(m);
  if (lane == 0) warp_part[warp] = m;
  __syncthreads();
  m = warp_part[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_part[w]);
  __syncthreads();
  float s = 0.0f;
  for (int l = threadIdx.x; l < L; l += kThreads) s += expf(a[l] - m);
  s = warp_sum(s);
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  s = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) s += warp_part[w];
  for (int l = threadIdx.x; l < L; l += kThreads) a[l] = round_to<T>(expf(a[l] - m) / s);
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

// SMP's value of (row, h): the s projection, -1e9 on pad rows (float32).
template <typename T>
__device__ __forceinline__ float smp_value(const MixArgs<T>& a, size_t row, int h) {
  return a.mask[row] > 0 ? to_f32(a.proj[row * 5 * a.H + 3 * a.H + h]) : kNegInf;
}

// mixed[row, h] = where(mask, (ga + smp) + lmp, 0), rounded to T after each
// sum as the TPU kernel rounds; `run` is the row's finished run summary.
template <typename T>
__device__ __forceinline__ void mix_store(const MixArgs<T>& a, int b, int l, int h, Top2 run) {
  const int L = a.L, H = a.H;
  const size_t row = (size_t)b * L + l;
  if (a.mask[row] <= 0) {
    a.mixed[row * H + h] = from_f32<T>(0.0f);
    return;
  }
  const size_t ld = 5 * (size_t)H;
  const float x = to_f32(a.proj[row * ld + 3 * H + h]);
  const float tok_m2 = run.m2 <= 0.5f * kNegInf ? run.m1 : run.m2;
  const float smp = x >= run.m1 ? tok_m2 : run.m1;
  const float ga = round_to<T>(__fmul_rn(a.gp[(size_t)b * H + h], to_f32(a.proj[row * ld + h])));
  const float neg = round_to<T>(kNegInf);
  const int half = a.window / 2;
  float lmp = neg;
  for (int off = -half; off < a.window - half; ++off) {
    const int j = l + off;
    if (j < 0 || j >= L) continue;
    const size_t rj = (size_t)b * L + j;
    lmp = fmaxf(lmp, a.mask[rj] > 0 ? to_f32(a.proj[rj * ld + 4 * H + h]) : neg);
  }
  const float v = round_to<T>(__fadd_rn(round_to<T>(__fadd_rn(ga, smp)), lmp));
  a.mixed[row * H + h] = from_f32<T>(v);
}

// The run starts of the tile's rows t0 .. t1 (t1 included: a row starts a
// run when it is the first, the end of the sequence, or its id differs from
// the previous row's), into shared `starts` (n + 1 flags).
__device__ __forceinline__ void load_starts(const int* seg, int b, int L, int t0, int t1,
                                            int* starts) {
  for (int i = threadIdx.x; i <= t1 - t0; i += kThreads) {
    const int l = t0 + i;
    starts[i] = (l == 0 || l == L || seg[(size_t)b * L + l] != seg[(size_t)b * L + l - 1]) ? 1 : 0;
  }
  __syncthreads();
}

// Tile flags: bit 0 a run starts inside (t0, t1), bit 1 at t0, bit 2 at t1.
constexpr int kStartInside = 1, kStartAtFirst = 2, kStartAtEnd = 4;

// SMP pass 1. Grid (ceil(H / kCols), ceil(L / kSmpRows), B): a thread per
// (tile, column) walks the tile's rows, mixes and writes every run that
// starts and ends in the tile, and writes the summaries of the first and the
// last fragment (first, last: (B, tiles, H) pairs); one thread writes the
// tile's flags.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    smp_tiles_kernel(MixArgs<T> a, const int* __restrict__ seg, Top2* __restrict__ first,
                     Top2* __restrict__ last, int* __restrict__ flags) {
  __shared__ int starts[kSmpRows + 1];
  const int L = a.L, H = a.H, tile = blockIdx.y, b = blockIdx.z, tiles = gridDim.y;
  const int t0 = tile * kSmpRows, t1 = min(L, t0 + kSmpRows), n = t1 - t0;
  load_starts(seg, b, L, t0, t1, starts);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int inside = 0;
    for (int i = 1; i < n; ++i) inside |= starts[i];
    flags[(size_t)b * tiles + tile] =
        (inside ? kStartInside : 0) | (starts[0] ? kStartAtFirst : 0) | (starts[n] ? kStartAtEnd : 0);
  }
  const int h = blockIdx.x * kCols + threadIdx.x;
  if (h >= H) return;
  const size_t slot = ((size_t)b * tiles + tile) * H + h;
  int fs = t0;
  Top2 acc = top2_of(smp_value(a, (size_t)b * L + t0, h));
  for (int l = t0 + 1; l <= t1; ++l) {
    if (l < t1 && !starts[l - t0]) {
      acc = top2_combine(acc, top2_of(smp_value(a, (size_t)b * L + l, h)));
      continue;
    }
    // the fragment [fs, l) ends here
    if (fs == t0) first[slot] = acc;
    if (l == t1) last[slot] = acc;
    if (starts[fs - t0] && starts[l - t0])
      for (int r = fs; r < l; ++r) mix_store(a, b, r, h, acc);
    if (l < t1) {
      fs = l;
      acc = top2_of(smp_value(a, (size_t)b * L + l, h));
    }
  }
}

// The summary of a fragment that reaches its tile's end, extended over the
// following tiles' first fragments until the run ends.
__device__ __forceinline__ Top2 extend_right(Top2 acc, const Top2* first, const int* flags,
                                             int b, int tile, int tiles, int H, int h) {
  for (int tt = tile + 1; tt < tiles; ++tt) {
    acc = top2_combine(acc, first[((size_t)b * tiles + tt) * H + h]);
    if (flags[(size_t)b * tiles + tt] & (kStartInside | kStartAtEnd)) break;
  }
  return acc;
}

// SMP pass 2, same grid: completes the tile's first and last fragments when
// their run crosses the tile's edges, then mixes and writes their rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    smp_edges_kernel(MixArgs<T> a, const int* __restrict__ seg, const Top2* __restrict__ first,
                     const Top2* __restrict__ last, const int* __restrict__ flags) {
  __shared__ int starts[kSmpRows + 1];
  const int L = a.L, H = a.H, tile = blockIdx.y, b = blockIdx.z, tiles = gridDim.y;
  const int t0 = tile * kSmpRows, t1 = min(L, t0 + kSmpRows), n = t1 - t0;
  load_starts(seg, b, L, t0, t1, starts);
  const int h = blockIdx.x * kCols + threadIdx.x;
  if (h >= H) return;
  int e1 = t1;  // the first fragment is [t0, e1)
  for (int i = 1; i < n; ++i)
    if (starts[i]) {
      e1 = t0 + i;
      break;
    }
  const size_t slot = ((size_t)b * tiles + tile) * H + h;
  if (!(starts[0] && starts[e1 - t0])) {
    Top2 acc = first[slot];
    if (!starts[0]) {
      for (int tt = tile - 1; tt >= 0; --tt) {
        acc = top2_combine(acc, last[((size_t)b * tiles + tt) * H + h]);
        if (flags[(size_t)b * tiles + tt] & (kStartInside | kStartAtFirst)) break;
      }
    }
    if (!starts[e1 - t0]) acc = extend_right(acc, first, flags, b, tile, tiles, H, h);
    for (int r = t0; r < e1; ++r) mix_store(a, b, r, h, acc);
  }
  if (e1 == t1 || starts[n]) return;  // one fragment, or the last one is complete
  int s2 = e1;  // the last fragment is [s2, t1)
  for (int i = n - 1; i > e1 - t0; --i)
    if (starts[i]) {
      s2 = t0 + i;
      break;
    }
  const Top2 acc = extend_right(last[slot], first, flags, b, tile, tiles, H, h);
  for (int r = s2; r < t1; ++r) mix_store(a, b, r, h, acc);
}

// The scratch of one call; see spk_ponet_block.
template <typename T>
struct Scratch {
  T* proj;         // (M, 5H)
  float* partial;  // (B, ceil(L / kGaRows), H)
  float* g;        // (B, H)
  float* att;      // (B, L): scores, then the rounded softmax weights
  float* gp;       // (B, H)
  T* mixed;        // (M, H)
  Top2* first;     // (B, ceil(L / kSmpRows), H)
  Top2* last;      // (B, ceil(L / kSmpRows), H)
  int* flags;      // (B, ceil(L / kSmpRows))
  int8_t* x8;      // (M, H), W8A8 only
  float* scales;   // (M), W8A8 only
  float* rows;     // (M, H) pre-norm rows of the epilogue
};

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
  // 2. GA: g, the scores and their softmax, gp
  const int nch = (L + kGaRows - 1) / kGaRows;
  const dim3 col_grid((H + kCols - 1) / kCols, nch, B), fin_grid((H + kCols - 1) / kCols, B);
  ga_partial_kernel<T><<<col_grid, kThreads, 0, stream>>>(s.proj, 5 * H, mask, nullptr, s.partial,
                                                          L, H);
  ga_finish_kernel<T><<<fin_grid, kThreads, 0, stream>>>(s.partial, nch, mask, L, H, s.g);
  ga_scores_kernel<T><<<(M + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      s.proj, s.g, mask, s.att, B, L, H, sm_scale);
  ga_softmax_kernel<T><<<B, kThreads, 0, stream>>>(s.att, L);
  ga_partial_kernel<T><<<col_grid, kThreads, 0, stream>>>(s.proj + 2 * H, 5 * H, mask, s.att,
                                                          s.partial, L, H);
  ga_finish_kernel<T><<<fin_grid, kThreads, 0, stream>>>(s.partial, nch, nullptr, L, H, s.gp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 3 + 4. SMP, LMP and the mix
  const MixArgs<T> args{s.proj, mask, s.gp, s.mixed, L, H, window};
  const dim3 smp_grid((H + kCols - 1) / kCols, (L + kSmpRows - 1) / kSmpRows, B);
  smp_tiles_kernel<T><<<smp_grid, kThreads, 0, stream>>>(args, seg, s.first, s.last, s.flags);
  smp_edges_kernel<T><<<smp_grid, kThreads, 0, stream>>>(args, seg, s.first, s.last, s.flags);
  err = cudaGetLastError();
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
                      void* proj, void* partial, void* g, void* att, void* gp, void* mixed,
                      void* first, void* last, void* flags, void* x8, void* scales, void* rows,
                      void* out, int B, int L, int H, int window, int fuse_ln, float sm_scale,
                      float eps, void* stream) {
  const Scratch<T> s{static_cast<T*>(proj),      static_cast<float*>(partial),
                     static_cast<float*>(g),     static_cast<float*>(att),
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
                               void* partial, void* g, void* att, void* gp, void* mixed,
                               void* first, void* last, void* flags, void* x8, void* scales,
                               void* rows, void* out, int B, int L, int H, int window, int fuse_ln,
                               float sm_scale, float eps, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || window <= 0 || (quantized && H % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return spk::ponet_block_entry<float>(quantized, x, mask, seg, wp, swp, bp, wo, swo, bo,
                                         ln_scale, ln_bias, proj, partial, g, att, gp, mixed,
                                         first, last, flags, x8, scales, rows, out, B, L, H,
                                         window, fuse_ln, sm_scale, eps, stream);
  if (dtype == 1)
    return spk::ponet_block_entry<__nv_bfloat16>(quantized, x, mask, seg, wp, swp, bp, wo, swo,
                                                 bo, ln_scale, ln_bias, proj, partial, g, att, gp,
                                                 mixed, first, last, flags, x8, scales, rows, out,
                                                 B, L, H, window, fuse_ln, sm_scale, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
