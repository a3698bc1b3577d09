// Greedy NMS over unsorted candidates: the kept scores of G independent
// (image, class) instances.
//
// Replaces the Pallas kernel `_nms_kernel` of
// paddle_lite_tpu/ops/kernels/nms.py.  For each instance, with candidate
// boxes b[i] = (x1, y1, x2, y2) and scores s[i], i < k:
//   valid[i]   = s[i] > score_t
//   beats(j,i) = s[j] > s[i] || (s[j] == s[i] && j < i)
//   sup(j,i)   = beats(j,i) && inter(j,i) > iou_t * uni(j,i)
//                (with iou_div: beats(j,i) && inter(j,i) / max(uni(j,i), 1e-10) > iou_t)
//   uni(j,i)   = (area[j] + area[i]) - inter(j,i)
//   keep[i]    = valid[i] && no kept j with sup(j,i)
//   out[i]     = s[i] * (keep[i] ? 1 : 0)
// with ix = max(min(x2_j, x2_i) - max(x1_j, x1_i), 0), iy likewise,
// inter = ix * iy and area = max(x2 - x1, 0) * max(y2 - y1, 0), each a
// separate fp32 rounding (built with --fmad=false), as the TPU kernel does.
// The division form (iou_div, the IEEE division __fdiv_rn) is the test of
// the reference's _nms_single_class (paddle_lite_tpu/ops/detection.py,
// `_iou_matrix`), which generate_proposals runs: the two forms round
// differently near the threshold, so each caller gets its reference's.
// The TPU kernel reaches `keep` as a Jacobi fixed point (one vec-mat
// product with a (k, k) fp32 matrix a round).  The recurrence's fixed point
// is unique and equals greedy NMS taken in `beats` order, which is what
// this kernel computes.
//
// What bounds it on an H100: the pair tests, 13 fp32 operations (2 min, 4
// max, 3 sub, 2 mul, 1 add, 1 compare; no FMA) for each of the nv (nv - 1)
// / 2 pairs of valid candidates, against 24 bytes of device memory per
// candidate, so operations bind, at one fp32 instruction a lane a clock.
// The greedy order is a chain of dependent decisions, which is latency.
// The division form's test is 14 operations (one multiply fewer, a max and
// a division more; the division counted as one, a lower bound).  One block
// an instance: at G = 1 (the RPN's one image, k = 1,000) one SM works and
// the other 131 idle, so the time there is the chain's latency on one SM.
//
// Design: one block of THREADS per instance, the plan (shared bytes, blocks
// an SM) in ops/kernels/nms.py; at k = 528 a block takes 21.4 KB, and
// seven fit an SM by registers, so SSD's 672 instances run in one wave.
//  1. Sort.  Each thread holds J = P / THREADS consecutive 64-bit keys
//     (score descending, then slot; P = k rounded up to a power of two, at
//     least THREADS) in registers.  A bitonic network: strides of 32 J and
//     more go through shared memory (one barrier a stride), strides J ..
//     16 J by __shfl_xor_sync, strides below J between a thread's own
//     registers.
//  2. Stage the valid candidates in rank order: a float4 box and the area
//     by rank, and the rank of each slot.
//  3. The diagonal tiles: for each word of 32 ranks, a warp's lane q holds
//     row 32 u + q's bits against the word's columns c > r (all 32 walked
//     with broadcast loads, the same address in every lane, then masked, so
//     no lane's loop differs).
//  4. Word by word, only the kept ranks' rows are tested: a removed rank
//     suppresses nothing, so its row is never needed.  For word u, the
//     kept ranks of the words before it, 32 to a warp (row box and area in
//     registers), are tested against the word's 32 columns, and the bits
//     ORed across the warp (__reduce_or_sync) into the word's removed
//     bits; then warp 0 settles the word's 32 ranks in registers against
//     its diagonal tile (every lane reaches the same kept word) and appends
//     its kept ranks.  ceil(nv / 32) dependent steps, not nv; at SSD's
//     data (69 % kept) about 130,000 pair tests an instance instead of
//     the 156,672 of every tile on and above the diagonal (and the
//     139,128 pairs of valid candidates).
//  5. Out by slot, coalesced: s[i] * keep, with keep read from the kept
//     words at rank_of[i].
// min, max, + and * of fp32 are commutative, so testing the pair from the
// winner's side gives the TPU kernel's bits exactly (and the division
// form's: its quotient is of the same symmetric inter and uni).  Boxes are assumed
// finite: fminf / fmaxf drop a NaN where the reference's min / max would
// keep it.
//
// The constants below marked "ablation" are each built false only by
// paddle_lite_tpu_torch/tools/nms_ablation.py, to time what each part of
// the design is worth; the library is always built with all of them true.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 6;  // blocks an SM the registers must allow
constexpr int MAX_J = 16;      // keys a thread: P <= 2048
constexpr unsigned long long NO_KEY = 0xffffffffull;  // high word of an invalid key
constexpr unsigned FULL = 0xffffffffu;

// ablation: the pair test's compare and OR under one predicate (false: the
// compiler's select and add)
constexpr bool PREDICATED_OR = true;
// ablation: the sort's strides below 32 J in registers and shuffles
// (false: every stride through shared memory)
constexpr bool REGISTER_SORT = true;
// ablation: where k is not a power of two, its largest power of two and
// the rest sorted apart and merged by ranks (false: all P keys in one
// network)
constexpr bool SPLIT_SORT = true;

struct Layout {  // byte offsets into dynamic shared memory
  int words;     // ceil(k / 32): word columns, and tile rows
  int sort_n;    // P
  long long box, area, rank, kept, counts, region, total;
};

__host__ __device__ inline int pow2_at_least(int k) {
  int p = THREADS;
  while (p < k) p <<= 1;
  return p;
}

__host__ __device__ inline long long up16(long long b) { return (b + 15) & ~15LL; }

// the carve-up, as ops/kernels/nms.plan computes it: boxes (16 B) and
// areas by rank for 32 * words ranks, the rank of each slot, the kept
// word of each word column, the counts (valid candidates of each warp,
// the ranks kept so far, each word's removed bits), then one region that
// holds the sort's keys and, after them, the diagonal tiles and the kept
// ranks
__host__ __device__ inline Layout layout(int k) {
  Layout L;
  L.words = (k + 31) / 32;
  L.sort_n = pow2_at_least(k);
  const long long rows = 32LL * L.words;
  L.box = 0;
  L.area = L.box + 16 * rows;
  L.rank = L.area + 4 * rows;
  L.kept = L.rank + 4 * rows;
  L.counts = L.kept + up16(4LL * L.words);
  L.region = L.counts + up16(4LL * (WARPS + 1 + L.words));
  long long region = 256LL * L.words;  // 32 words a diagonal tile, 32 kept ranks
  if (8LL * L.sort_n > region) region = 8LL * L.sort_n;
  L.total = L.region + region;
  return L;
}

// fp32 -> uint32 increasing with the value; -0.0 maps as +0.0, since
// `beats` treats them as equal
__device__ __forceinline__ uint32_t ordered(float x) {
  if (x == 0.0f) x = 0.0f;
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The sort's two parts: keys [0, a) and [a, a + pb), each sorted on its
// own (pb = 0: one part of all P keys), then merged by ranks.  Splitting
// pays where k is not a power of two: SSD's k = 528 sorts 512 keys and
// 256 (the 16 left, padded to a warp's) on three warps instead of 1024 on
// four.  A part is a multiple of 32 J keys, so no warp spans two.
struct SortSplit {
  int a, pb;
};

__host__ __device__ inline SortSplit sort_split(int k, int P, int J) {
  int a = 1;
  while (2 * a <= k) a <<= 1;
  if (!SPLIT_SORT || a == k || a < 32 * J) return {P, 0};
  int pb = 32 * J;
  while (pb < k - a) pb <<= 1;
  return {a, pb};
}

// Bitonic sort of each part, ascending; thread `tid` holds elements
// J tid + j in v[j].  `key` is P words of shared memory.  A stage keeps
// in element e the smaller of the pair (e, e ^ stride) where e's bit
// `stride` equals its bit `size` in the part (both 0: ascending run, lower
// element).  Every thread meets every barrier.
template <int J>
__device__ void sort_keys(unsigned long long (&v)[J], unsigned long long* key,
                          int P, SortSplit sp, int tid) {
  const int lane = tid & 31;
  const int e0 = J * tid;  // this thread's first element
  const int base = e0 < sp.a ? 0 : sp.a;
  const int part = e0 < sp.a ? sp.a : (e0 < sp.a + sp.pb ? sp.pb : 0);  // 0: idle
  const int last = sp.a > sp.pb ? sp.a : sp.pb;
  constexpr int SHARED = REGISTER_SORT ? 32 * J : 1;  // strides below: no barrier
  for (int size = 2; size <= last; size <<= 1) {
    int stride = size >> 1;
    const bool on = size <= part;
    if (stride >= SHARED) {
#pragma unroll
      for (int j = 0; j < J; ++j) key[e0 + j] = v[j];
      __syncthreads();
      for (; stride >= SHARED; stride >>= 1) {
        for (int t = tid; t < P / 2; t += THREADS) {
          const int lo = 2 * t - (t & (stride - 1));
          const int b0 = lo < sp.a ? 0 : sp.a;
          if (size > (lo < sp.a ? sp.a : (lo < sp.a + sp.pb ? sp.pb : 0))) continue;
          const int hi = lo + stride;
          const unsigned long long x = key[lo], c = key[hi];
          if ((x > c) == (((lo - b0) & size) == 0)) {
            key[lo] = c;
            key[hi] = x;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < J; ++j) v[j] = key[e0 + j];
    }
    if (!REGISTER_SORT || !on) continue;
    // strides J .. 16 J: between lanes; size >= 2 J, so the run's
    // direction is the thread's
    for (; stride >= J; stride >>= 1) {
      const int m = stride / J;
      const bool keep_min = ((lane & m) == 0) == (((e0 - base) & size) == 0);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const unsigned long long other = __shfl_xor_sync(FULL, v[j], m);
        if ((other < v[j]) == keep_min) v[j] = other;
      }
    }
    // strides below J: between a thread's registers j and j ^ sj
#pragma unroll
    for (int sj = J / 2; sj >= 1; sj >>= 1) {
      if (sj <= stride) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (j & sj) continue;
          const bool asc = ((e0 - base + j) & size) == 0;
          const unsigned long long x = v[j], c = v[j | sj];
          if ((x > c) == asc) {
            v[j] = c;
            v[j | sj] = x;
          }
        }
      }
    }
  }
}

// Keys of the sorted array `arr` (n, a power of two) below x: all keys
// differ.
__device__ __forceinline__ int below(const unsigned long long* arr, int n,
                                     unsigned long long x) {
  int c = 0;
  for (int s = n >> 1; s >= 1; s >>= 1)
    if (arr[c + s - 1] < x) c += s;
  return c + (arr[c] < x ? 1 : 0);
}

// The 32 bits of one row (box rb, area ra) against the columns cb[q],
// ca4 (areas, four a float4): bit q = sup(row, column q).  CLAMP_Y false
// leaves out iy's clamp at 0, which changes no bit when iou_t >= 0 (or
// -0): with ix >= 0 and iy < 0, inter = ix * iy <= 0 where the reference
// has +0, uni = (area_r + area_c) - inter >= 0 is at least the
// reference's, so iou_t * uni >= 0 (or NaN), and both tests are false;
// with iy >= 0 every value is the reference's.  (A NaN iou_t takes the
// clamped form.)  The compare and the OR go under one predicate: the
// compiler's select-and-add took a slot and a half a pair more.  DIV tests
// inter / max(uni, 1e-10) > iou_t instead; CLAMP_Y false changes no bit
// there either: with iy < 0 the quotient is <= 0 (or -0), below any
// iou_t >= 0, as the reference's 0 / max(uni, 1e-10) is.
template <bool CLAMP_Y, bool DIV>
__device__ __forceinline__ uint32_t row_bits(const float4 rb, const float ra,
                                             const float4* __restrict__ cb,
                                             const float4* __restrict__ ca4, float iou_t) {
  uint32_t bits = 0u;
#pragma unroll
  for (int q4 = 0; q4 < 8; ++q4) {
    const float4 ca = ca4[q4];
    const float cas[4] = {ca.x, ca.y, ca.z, ca.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 c = cb[4 * q4 + u];
      const float ix = fmaxf(fminf(rb.z, c.z) - fmaxf(rb.x, c.x), 0.0f);
      const float dy = fminf(rb.w, c.w) - fmaxf(rb.y, c.y);
      const float iy = CLAMP_Y ? fmaxf(dy, 0.0f) : dy;
      const float inter = ix * iy;
      const float uni = (ra + cas[u]) - inter;
      // the test lhs > rhs of the form asked for
      const float lhs = DIV ? __fdiv_rn(inter, fmaxf(uni, 1e-10f)) : inter;
      const float rhs = DIV ? iou_t : iou_t * uni;
      if (PREDICATED_OR) {
        asm("{\n\t.reg .pred p;\n\tsetp.gt.f32 p, %1, %2;\n\t@p or.b32 %0, %0, %3;\n\t}"
            : "+r"(bits) : "f"(lhs), "f"(rhs), "r"(1u << (4 * q4 + u)));
      } else if (lhs > rhs) {
        bits |= 1u << (4 * q4 + u);
      }
    }
  }
  return bits;
}

// The 32 bits of row `lane` of diagonal tile u: sup(32 u + lane, 32 u +
// q), all 32 columns tested and then masked by q > lane, so no lane's
// loop differs.
template <bool CLAMP_Y, bool DIV>
__device__ __forceinline__ uint32_t diag_bits(const float4* __restrict__ box,
                                              const float* __restrict__ area, int u, int lane,
                                              float iou_t) {
  const int r = 32 * u + lane;
  const uint32_t bits = row_bits<CLAMP_Y, DIV>(box[r], area[r], box + 32 * u,
                                          reinterpret_cast<const float4*>(area + 32 * u), iou_t);
  return bits & (lane == 31 ? 0u : (FULL << (lane + 1)));
}

// Rank q of a word is kept when no kept rank removed it: settles the 32
// ranks of a word in order, from `rem` (removed by earlier words) and row
// `lane` of the word's diagonal tile in each lane; every lane returns the
// same removed bits.
__device__ __forceinline__ uint32_t settle(uint32_t rem, const uint32_t d) {
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const uint32_t dq = __shfl_sync(FULL, d, q);
    if (!(rem & (1u << q))) rem |= dq;  // rank q kept: its row removes
  }
  return rem;
}

template <int J, bool DIV>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
nms_keep_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                float* __restrict__ out, int k, float iou_t, float score_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(k);
  float4* box = reinterpret_cast<float4*>(smem + L.box);
  float* area = reinterpret_cast<float*>(smem + L.area);
  int* rank_of = reinterpret_cast<int*>(smem + L.rank);
  uint32_t* kept = reinterpret_cast<uint32_t*>(smem + L.kept);
  int* warp_valid = reinterpret_cast<int*>(smem + L.counts);  // WARPS counts,
  int* nk = warp_valid + WARPS;                                 // ranks kept so far,
  uint32_t* rem = reinterpret_cast<uint32_t*>(nk + 1);          // removed, by word
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem + L.region);
  uint32_t* diag = reinterpret_cast<uint32_t*>(smem + L.region);  // 32 words a word column
  int* krow = reinterpret_cast<int*>(diag + 32 * L.words);        // the kept ranks

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* sc = scores + (size_t)blockIdx.x * k;
  const float4* b = reinterpret_cast<const float4*>(boxes) + (size_t)blockIdx.x * k;

  // 1. keys, the valid ones counted by ballots, then the sort and the ranks
  unsigned long long v[J];
  int valid_here = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = J * tid + j;
    bool ok = false;
    v[j] = NO_KEY << 32 | (uint32_t)e;  // after every valid key; all keys differ
    if (e < k) {
      const float s = __ldg(sc + e);
      ok = s > score_t;
      if (ok) v[j] = ((unsigned long long)(~ordered(s)) << 32) | (uint32_t)e;
    }
    valid_here += __popc(__ballot_sync(FULL, ok));
  }
  if (lane == 0) warp_valid[warp] = valid_here;
  const SortSplit sp = sort_split(k, L.sort_n, J);
  sort_keys<J>(v, key, L.sort_n, sp, tid);
  // the rank of each key: its place in its part, plus the keys of the
  // other part below it
  int rank[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    rank[j] = J * tid + j;
    key[rank[j]] = v[j];
  }
  __syncthreads();  // also publishes warp_valid
  if (sp.pb) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (rank[j] < sp.a) rank[j] += below(key + sp.a, sp.pb, v[j]);
      else if (rank[j] < sp.a + sp.pb) rank[j] += below(key, sp.a, v[j]) - sp.a;
    }
  }
  int nv = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) nv += warp_valid[i];
  const int words = (nv + 31) / 32;

  // 2. the valid candidates in rank order
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int r = rank[j];
    if (r < nv) {
      const int i = (int)(v[j] & 0xffffffffu);
      const float4 x = __ldg(b + i);
      box[r] = x;
      area[r] = fmaxf(x.z - x.x, 0.0f) * fmaxf(x.w - x.y, 0.0f);
      rank_of[i] = r;
    }
  }
  for (int t = tid; t < words; t += THREADS) rem[t] = 0u;
  if (tid == 0) *nk = 0;
  __syncthreads();

  // 3. the diagonal tiles, a warp a tile
  for (int u = warp; u < words; u += WARPS)
    diag[32 * u + lane] = iou_t >= 0.0f ? diag_bits<false, DIV>(box, area, u, lane, iou_t)
                                        : diag_bits<true, DIV>(box, area, u, lane, iou_t);
  __syncthreads();
  // 4. word by word: the kept rows so far, 32 to a warp, against the
  // word's columns, ORed into its removed bits; then warp 0 settles the
  // word and appends its kept ranks
  for (int u = 0; u < words; ++u) {
    const int n = *nk;
    const float4* cb = box + 32 * u;
    const float4* ca4 = reinterpret_cast<const float4*>(area + 32 * u);
    for (int g = warp; 32 * g < n; g += WARPS) {
      const int i = 32 * g + lane;
      uint32_t bits = 0u;
      if (i < n) {
        const int r = krow[i];
        bits = iou_t >= 0.0f ? row_bits<false, DIV>(box[r], area[r], cb, ca4, iou_t)
                             : row_bits<true, DIV>(box[r], area[r], cb, ca4, iou_t);
      }
      bits = __reduce_or_sync(FULL, bits);
      if (lane == 0 && bits) atomicOr(rem + u, bits);
    }
    __syncthreads();
    if (warp == 0) {
      const int left = nv - 32 * u;
      const uint32_t kw = ~settle(rem[u], diag[32 * u + lane]) &
                          (left >= 32 ? FULL : (1u << left) - 1u);
      if (lane == 0) {
        kept[u] = kw;
        *nk = n + __popc(kw);
      }
      if ((kw >> lane) & 1u) krow[n + __popc(kw & ((1u << lane) - 1u))] = 32 * u + lane;
    }
    __syncthreads();
  }
  // 5. out by slot
  float* o = out + (size_t)blockIdx.x * k;
  for (int i = tid; i < k; i += THREADS) {
    const float s = __ldg(sc + i);
    const bool valid = s > score_t;
    const int r = valid ? rank_of[i] : 0;
    const bool keep = valid && ((kept[r >> 5] >> (r & 31)) & 1u);
    o[i] = s * (keep ? 1.0f : 0.0f);
  }
}

using Kernel = void (*)(const float*, const float*, float*, int, float, float);

template <bool DIV>
Kernel pick(int k) {
  switch (pow2_at_least(k) / THREADS) {
    case 1: return nms_keep_kernel<1, DIV>;
    case 2: return nms_keep_kernel<2, DIV>;
    case 4: return nms_keep_kernel<4, DIV>;
    case 8: return nms_keep_kernel<8, DIV>;
    case 16: return nms_keep_kernel<MAX_J, DIV>;
    default: return nullptr;
  }
}

const Kernel ALL[] = {nms_keep_kernel<1, false>, nms_keep_kernel<2, false>,
                      nms_keep_kernel<4, false>, nms_keep_kernel<8, false>,
                      nms_keep_kernel<MAX_J, false>, nms_keep_kernel<1, true>,
                      nms_keep_kernel<2, true>,  nms_keep_kernel<4, true>,
                      nms_keep_kernel<8, true>,  nms_keep_kernel<MAX_J, true>};

cudaError_t device_attr(int* to, cudaDeviceAttr attr) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e != cudaSuccess ? e : cudaDeviceGetAttribute(to, attr, dev);
}

}  // namespace

// Dynamic shared memory the kernel needs for k candidates.
extern "C" long long plt_nms_smem_bytes(int k) { return layout(k).total; }

// Lets every instantiation take all the dynamic shared memory a block may
// on the current device.  The wrapper runs it once per device, when the
// library is first used there (never inside a CUDA-graph capture).
// Returns the first CUDA error, or 0.
extern "C" int plt_nms_prepare() {
  int optin = 0;
  cudaError_t e = device_attr(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin);
  for (const Kernel kern : ALL) {
    if (e != cudaSuccess) break;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  return static_cast<int>(e);
}

// The kernel's layout on the current device, for ops/kernels/nms.plan:
// threads a block, the most blocks an SM holds by registers and threads
// (the fewest over the instantiations), the SMs, the shared bytes an SM
// has, the bytes the runtime keeps for each block, and the most one block
// may take.  Returns a CUDA error, or 0.
extern "C" int plt_nms_layout(int* threads, int* blocks_per_sm, int* sms,
                              int* smem_per_sm, int* smem_reserved, int* smem_per_block) {
  cudaError_t e = device_attr(sms, cudaDevAttrMultiProcessorCount);
  if (e == cudaSuccess) e = device_attr(smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor);
  if (e == cudaSuccess) e = device_attr(smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock);
  if (e == cudaSuccess) e = device_attr(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin);
  int fewest = -1;
  for (const Kernel kern : ALL) {
    if (e != cudaSuccess) break;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, 0);
    if (fewest < 0 || n < fewest) fewest = n;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = THREADS;
  *blocks_per_sm = fewest;
  return fewest < 1 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// C interface, bound with ctypes.  Device pointers: boxes (G, k, 4) fp32,
// 16-byte aligned, scores (G, k) fp32, out (G, k) fp32, all contiguous.
// iou_div != 0 takes the division form of the pair test.
// The launch makes no attribute calls (plt_nms_prepare made them).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue (1)
// for a k past the sort's 2048 keys or misaligned boxes; a k whose
// shared memory (plt_nms_smem_bytes) is past the block's limit fails at
// the launch.
extern "C" int plt_nms_keep(const void* boxes, const void* scores, void* out,
                            int G, int k, float iou_t, float score_t, int iou_div,
                            void* stream) {
  if (G < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)G * k == 0) return static_cast<int>(cudaGetLastError());
  const Kernel kern = iou_div ? pick<true>(k) : pick<false>(k);
  if (kern == nullptr || reinterpret_cast<uintptr_t>(boxes) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(boxes);
  const float* s = static_cast<const float*>(scores);
  float* o = static_cast<float*>(out);
  void* params[] = {&b, &s, &o, &k, &iou_t, &score_t};
  const cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(kern), dim3(G),
                                         dim3(THREADS), params,
                                         (size_t)plt_nms_smem_bytes(k),
                                         static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
