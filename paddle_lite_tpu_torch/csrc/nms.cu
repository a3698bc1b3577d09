// Greedy NMS over unsorted candidates: the kept scores of G independent
// (image, class) instances.
//
// Replaces the Pallas kernel `_nms_kernel` of
// paddle_lite_tpu/ops/kernels/nms.py.  For each instance, with candidate
// boxes b[i] = (x1, y1, x2, y2) and scores s[i], i < k:
//   valid[i]   = s[i] > score_t
//   beats(j,i) = s[j] > s[i] || (s[j] == s[i] && j < i)
//   sup(j,i)   = beats(j,i) && inter(j,i) > iou_t * ((area[j] + area[i]) - inter(j,i))
//   keep[i]    = valid[i] && no kept j with sup(j,i)
//   out[i]     = s[i] * (keep[i] ? 1 : 0)
// with ix = max(min(x2_j, x2_i) - max(x1_j, x1_i), 0), iy likewise,
// inter = ix * iy and area = max(x2 - x1, 0) * max(y2 - y1, 0), each a
// separate fp32 rounding (built with --fmad=false), as the TPU kernel does.
// The TPU kernel reaches `keep` as a Jacobi fixed point (one vec-mat
// product with a (k, k) fp32 matrix a round).  The recurrence's fixed point
// is unique and equals greedy NMS taken in `beats` order, which is what
// this kernel computes.
//
// Design: one block per instance, everything in shared memory.
//  1. Stage boxes, areas and scores.  Sort the valid candidates into
//     `beats` order with a bitonic sort of 64-bit keys (score, descending,
//     then index); candidates arrive unsorted, since the bucket tier yields
//     them in bucket order.  Move boxes and areas into that order.
//  2. Build the suppression relation as a bitmask over ranks, row r
//     holding sup(r, c) for the later ranks c > r only: nv * ceil(nv/32)
//     words for nv valid candidates (35.9 KB at nv = k = 528, where the TPU
//     kernel's fp32 matrix would take 1.1 MB).  A warp takes one word of 32
//     consecutive rows, so all its lanes read the same column (a broadcast).
//  3. One warp sweeps the ranks in order, the removed set held in its
//     lanes' registers (one word a lane): keep a rank no kept predecessor
//     removed, and OR its row into the set.
// min, max, + and * of fp32 are commutative, so testing the pair from the
// winner's side gives the TPU kernel's bits exactly.
//
// What bounds it on an H100: the pair tests, 13 fp32 operations for each of
// the nv (nv - 1) / 2 pairs of valid candidates (what this kernel
// computes; the TPU kernel tests all k^2), against 24 bytes of device
// memory per candidate (some 140 operations a byte at nv = k = 528), so
// operations bind, at the fp32 CUDA-core rate.  The sweep is sequential,
// one step per valid candidate, and is latency; other blocks on the same SM
// build their masks meanwhile.  Boxes are assumed finite: fminf / fmaxf
// drop a NaN where the reference's min / max would keep it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned long long NO_KEY = ~0ull;

struct Layout {  // byte offsets into dynamic shared memory
  long long words, pow2, order, kept, region, total;
};

__host__ __device__ inline Layout layout(int k) {
  Layout L;
  L.words = (k + 31) / 32;
  L.pow2 = 1;
  while (L.pow2 < k) L.pow2 <<= 1;
  L.order = 4LL * 6 * k;                      // x1 y1 x2 y2 area s (fp32)
  L.kept = L.order + 4LL * k;                 // order: rank -> candidate
  L.region = (L.kept + 4 * L.words + 7) & ~7LL;
  long long region = 4LL * k * L.words;       // the bitmask
  if (8 * L.pow2 > region) region = 8 * L.pow2;  // the sort keys
  if (4LL * 5 * k > region) region = 4LL * 5 * k;  // the reorder buffer
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

__global__ void __launch_bounds__(THREADS)
nms_keep_kernel(const float* __restrict__ boxes,
                const float* __restrict__ scores, float* __restrict__ out,
                int k, float iou_t, float score_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(k);
  float* f[5];  // x1, y1, x2, y2, area: by candidate, then by rank
#pragma unroll
  for (int c = 0; c < 5; ++c) f[c] = reinterpret_cast<float*>(smem) + c * k;
  float* s = reinterpret_cast<float*>(smem) + 5 * k;
  int* order = reinterpret_cast<int*>(smem + L.order);
  uint32_t* kept = reinterpret_cast<uint32_t*>(smem + L.kept);
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem + L.region);
  float* tmp = reinterpret_cast<float*>(smem + L.region);
  uint32_t* sup = reinterpret_cast<uint32_t*>(smem + L.region);
  __shared__ int n_valid;

  const int tid = threadIdx.x;
  const int P = (int)L.pow2;
  const float* b = boxes + (size_t)blockIdx.x * k * 4;
  const float* sc = scores + (size_t)blockIdx.x * k;
  if (tid == 0) n_valid = 0;
  __syncthreads();
  for (int i = tid; i < P; i += THREADS) {
    unsigned long long kv = NO_KEY;
    if (i < k) {
      const float x1 = b[4 * i], y1 = b[4 * i + 1];
      const float x2 = b[4 * i + 2], y2 = b[4 * i + 3];
      f[0][i] = x1;
      f[1][i] = y1;
      f[2][i] = x2;
      f[3][i] = y2;
      f[4][i] = fmaxf(x2 - x1, 0.0f) * fmaxf(y2 - y1, 0.0f);
      const float si = sc[i];
      s[i] = si;
      if (si > score_t) {
        kv = ((unsigned long long)(~ordered(si)) << 32) | (uint32_t)i;
        atomicAdd(&n_valid, 1);
      }
    }
    key[i] = kv;
  }
  __syncthreads();

  // 1. bitonic sort, ascending keys = descending scores, then index
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = key[lo], c = key[hi];
        if ((a > c) == ((lo & size) == 0)) {
          key[lo] = c;
          key[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  const int nv = n_valid;
  for (int r = tid; r < nv; r += THREADS) order[r] = (int)(key[r] & 0xffffffffu);
  __syncthreads();
  for (int r = tid; r < nv; r += THREADS) {
    const int i = order[r];
#pragma unroll
    for (int c = 0; c < 5; ++c) tmp[c * nv + r] = f[c][i];
  }
  __syncthreads();
  for (int r = tid; r < nv; r += THREADS) {
#pragma unroll
    for (int c = 0; c < 5; ++c) f[c][r] = tmp[c * nv + r];
  }
  __syncthreads();

  // 2. bitmask over ranks: row r, word w holds sup(r, 32 w + q) for c > r
  const int wv = (nv + 31) / 32;
  for (int t = tid; t < nv * wv; t += THREADS) {
    const int r = t % nv;
    const int w = t / nv;
    const float ax1 = f[0][r], ay1 = f[1][r], ax2 = f[2][r], ay2 = f[3][r];
    const float aa = f[4][r];
    const int c0 = max(32 * w, r + 1);
    const int c1 = min(32 * w + 32, nv);
    uint32_t bits = 0u;
    for (int c = c0; c < c1; ++c) {
      const float ix = fmaxf(fminf(ax2, f[2][c]) - fmaxf(ax1, f[0][c]), 0.0f);
      const float iy = fmaxf(fminf(ay2, f[3][c]) - fmaxf(ay1, f[1][c]), 0.0f);
      const float inter = ix * iy;
      const float uni = (aa + f[4][c]) - inter;
      if (inter > iou_t * uni) bits |= 1u << (c - 32 * w);
    }
    sup[(size_t)r * wv + w] = bits;
  }
  __syncthreads();

  // 3. greedy sweep in rank order, one warp; lane l holds removed words l
  // and l + 32 (wv <= 64: k is below 2048 by the shared-memory limit)
  if (tid < 32) {
    uint32_t rem0 = 0u, rem1 = 0u, kp0 = 0u, kp1 = 0u;
    for (int r = 0; r < nv; ++r) {
      const int w = r >> 5;
      const int src = w & 31;
      const bool hi = w >= 32;
      const uint32_t word = __shfl_sync(0xffffffffu, hi ? rem1 : rem0, src);
      if (!((word >> (r & 31)) & 1u)) {
        const uint32_t bit = 1u << (r & 31);
        if (tid == src) {
          if (hi) kp1 |= bit;
          else kp0 |= bit;
        }
        const uint32_t* row = sup + (size_t)r * wv;
        if (tid < wv) rem0 |= row[tid];
        if (tid + 32 < wv) rem1 |= row[tid + 32];
      }
    }
    if (tid < wv) kept[tid] = kp0;
    if (tid + 32 < wv) kept[tid + 32] = kp1;
  }
  __syncthreads();

  float* o = out + (size_t)blockIdx.x * k;
  for (int i = tid; i < k; i += THREADS)
    if (!(s[i] > score_t)) o[i] = s[i] * 0.0f;
  for (int r = tid; r < nv; r += THREADS) {
    const int i = order[r];
    o[i] = s[i] * (((kept[r >> 5] >> (r & 31)) & 1u) ? 1.0f : 0.0f);
  }
}

}  // namespace

// Dynamic shared memory the kernel needs for k candidates.
extern "C" long long plt_nms_smem_bytes(int k) { return layout(k).total; }

// C interface, bound with ctypes.  Device pointers: boxes (G, k, 4) fp32,
// scores (G, k) fp32, out (G, k) fp32, all contiguous.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue (1) when k
// candidates do not fit in one block's shared memory.
extern "C" int plt_nms_keep(const void* boxes, const void* scores, void* out,
                            int G, int k, float iou_t, float score_t,
                            void* stream) {
  // The shared-memory opt-in is set once per device and size, so a launch
  // captured into a CUDA graph (after a first, uncaptured call) makes no
  // attribute calls.
  constexpr int MAX_DEVICES = 64;
  static int max_optin[MAX_DEVICES] = {0};
  static long long configured[MAX_DEVICES] = {0};
  if ((long long)G * k == 0) return static_cast<int>(cudaGetLastError());
  const long long smem = plt_nms_smem_bytes(k);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (max_optin[dev] == 0) {
    e = cudaDeviceGetAttribute(&max_optin[dev],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (smem + 64 > max_optin[dev]) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > configured[dev]) {
    e = cudaFuncSetAttribute(nms_keep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[dev] = smem;
  }
  nms_keep_kernel<<<G, THREADS, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<float*>(out), k, iou_t, score_t);
  return static_cast<int>(cudaGetLastError());
}
