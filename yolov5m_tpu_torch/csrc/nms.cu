// Greedy class-aware NMS keep mask for Hopper (sm_90a): one launch per
// batch, one thread block per image, all state in shared memory.
//
// Replaces the Pallas TPU kernel yolov5m_tpu/ops/pallas/nms_kernel.py
// (_nms_kernel, entered through greedy_suppress_pallas). Same result: per
// image, over K score-sorted candidates,
//   S[i,j] = IoU(i,j) > t  &&  cls_i == cls_j  &&  j > i
//   keep   = the sequential greedy scan over S, gated by valid
// which is bit-identical to the fixpoint the TPU kernel iterates.
//
// What bounds it: the work these inputs need is small. Valid is read and
// keep written for every row (2 bytes), a box and class only for a valid
// row (20 bytes more: an invalid row is never kept and never suppresses),
// and the IoU decisions needed are one per pair of kept rows and one per
// removed valid row (by the kept row that removes it). Both are far below
// what the card's bytes or f32 rate take at the shapes used, so it is bound
// by latency: the launch, one round trip to stage an image, and a chain of
// dependent steps per image. With hundreds of kept rows (dense clusters at
// large K) the IoUs of one image, all issued by one SM, add to that chain.
// The design shortens the chain and does no work for rows that cannot
// change the mask (the TPU kernel's bf16 (K, K)
// VMEM matrix and MXU fixpoint are TPU choices and are not carried over;
// S never goes to global memory):
//   stage     cp.async copies the image's boxes and classes into shared
//             memory, and a warp ballot packs valid into ceil(K/32) words.
//   diagonal  the 32x32 diagonal tiles of S, which do not depend on what is
//             kept: every warp takes whole tiles, and each valid row of a
//             tile gets one ballot over the tile's later rows (a lane
//             computes the IoUs of kUnroll rows together, to hide latency).
//   sweep     tile by tile in score order. A tile with no live row (valid
//             and not removed) costs one word test. Otherwise every thread
//             resolves the tile's kept rows from its diagonal words with
//             bit operations alone, and each warp owns distinct later
//             "removed" words: for a word with a live row left, one IoU per
//             lane for each kept row, kUnroll rows to a ballot, ORed in
//             without atomics.
//             One __syncthreads per tile with a live row, so the serial
//             chain is at most ceil(K/32) steps instead of K.
//   write     keep = the kept words, one byte per row.
//
// Rounding: the IoU keeps the TPU kernel's operation order
// (area_c + area_r - inter + 1e-7, then divide) with explicitly rounded
// intrinsics, and the file is built with --fmad=false, so no FMA
// contraction changes a decision at IoU == t. The threshold is a float
// and the compare is in f32; classes compare with exact float equality.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 2048;
constexpr int kMaxWarps = 32;
constexpr int kUnroll = 4;  // rows whose IoUs a lane computes together

// Dynamic shared memory for an image of `words` 32-row tiles: boxes
// (float4), classes and diagonal words per row, then the valid, removed
// and kept words per tile. 49,920 bytes at K = 2048.
__host__ __device__ constexpr size_t smem_bytes(int words) {
  return (size_t)words * 32 * (sizeof(float4) + sizeof(float) +
                               sizeof(uint32_t)) +
         (size_t)words * 3 * sizeof(uint32_t);
}

// S[c, r] for row c and a later row r.
__device__ __forceinline__ bool suppresses(float4 c, float cls_c, float4 r,
                                           float cls_r, float t) {
  const float area_c = __fmul_rn(__fsub_rn(c.z, c.x), __fsub_rn(c.w, c.y));
  const float area_r = __fmul_rn(__fsub_rn(r.z, r.x), __fsub_rn(r.w, r.y));
  const float iw = fmaxf(__fsub_rn(fminf(c.z, r.z), fmaxf(c.x, r.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(c.w, r.w), fmaxf(c.y, r.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  // no overlap decides "no" for t >= 0 (0 / denom is 0 or NaN), and skips
  // the divide, whose zero dividend takes the IEEE divide's slow path
  if (!(inter > 0.0f) && t >= 0.0f) return false;
  const float denom =
      __fadd_rn(__fsub_rn(__fadd_rn(area_c, area_r), inter), 1e-7f);
  return __fdiv_rn(inter, denom) > t && cls_c == cls_r;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
greedy_keep_kernel(const float* __restrict__ boxes,
                   const float* __restrict__ cls,
                   const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, int k, float iou_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) >> 5;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* scls = reinterpret_cast<float*>(sbox + words * 32);
  uint32_t* diag = reinterpret_cast<uint32_t*>(scls + words * 32);
  uint32_t* valid_w = diag + words * 32;
  uint32_t* removed = valid_w + words;
  uint32_t* kept_w = removed + words;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;  // a multiple of 32
  const int nwarps = nthreads >> 5;
  const int64_t base = (int64_t)blockIdx.x * k;

  // stage: one 16-byte copy per box where the rows are 16-byte aligned
  // (the image's offset is a multiple of 16 bytes, so the base decides)
  const float* gbox = boxes + base * 4;
  const bool box16 = (reinterpret_cast<uintptr_t>(gbox) & 15u) == 0;
  for (int j = tid; j < k; j += nthreads) {
    if (box16) {
      __pipeline_memcpy_async(&sbox[j], gbox + 4 * j, 16);
    } else {
      float* dst = reinterpret_cast<float*>(&sbox[j]);
      for (int q = 0; q < 4; ++q)
        __pipeline_memcpy_async(dst + q, gbox + 4 * j + q, 4);
    }
    __pipeline_memcpy_async(&scls[j], cls + base + j, 4);
  }
  __pipeline_commit();
  // valid is never assumed to be a prefix: any mask is packed as it is
  for (int j = tid; j < words * 32; j += nthreads) {  // whole warps
    const uint32_t word = __ballot_sync(0xffffffffu, j < k && valid[base + j]);
    if (lane == 0) {
      valid_w[j >> 5] = word;
      removed[j >> 5] = 0u;
      kept_w[j >> 5] = 0u;
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // diagonal tiles: diag[i] bit c = S[i, 32t + c] within i's own tile t
  for (int t = warp; t < words; t += nwarps) {
    const int j = t * 32 + lane;
    const int jj = j < k ? j : k - 1;  // rows past K are never staged
    const float4 bj = sbox[jj];
    const float cj = scls[jj];
    uint32_t rows = valid_w[t];
    while (rows) {  // kUnroll rows at a time: independent IoUs in flight
      int rr[kUnroll];
      bool sup[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool has = rows != 0u;
        rr[u] = has ? __ffs(rows) - 1 : -1;
        rows &= rows - 1;
        const int i = t * 32 + (has ? rr[u] : 0);
        sup[u] = has & (lane > rr[u]) & (j < k) &
                 suppresses(sbox[i], scls[i], bj, cj, iou_threshold);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t d = __ballot_sync(0xffffffffu, sup[u]);
        if (lane == 0 && rr[u] >= 0) diag[t * 32 + rr[u]] = d;
      }
    }
  }
  __syncthreads();

  // sweep: removed[t] is final when tile t is reached (only kept rows of
  // earlier tiles set it), and every thread reads the same words, so the
  // branches around __syncthreads are uniform over the block
  for (int t = 0; t < words; ++t) {
    const uint32_t live = valid_w[t] & ~removed[t];
    if (live == 0u) continue;
    uint32_t kept = 0u;
    uint32_t rest = live;
    while (rest) {  // the lowest live row is kept and removes its later ones
      const int r = __ffs(rest) - 1;
      kept |= 1u << r;
      rest &= rest - 1;
      rest &= ~diag[t * 32 + r];
    }
    if (tid == 0) kept_w[t] = kept;
    for (int w = t + 1 + warp; w < words; w += nwarps) {
      const uint32_t cols = valid_w[w] & ~removed[w];
      if (cols == 0u) continue;
      const int j = w * 32 + lane;
      const int jj = j < k ? j : k - 1;
      const float4 bj = sbox[jj];
      const float cj = scls[jj];
      const bool mine = (cols >> lane) & 1u;
      uint32_t hit = 0u;
      uint32_t rows = kept;
      while (rows && (cols & ~hit)) {  // stop once every live column is hit
        bool sup = false;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool has = rows != 0u;
          const int i = t * 32 + (has ? __ffs(rows) - 1 : 0);
          rows &= rows - 1;
          sup |= has & suppresses(sbox[i], scls[i], bj, cj, iou_threshold);
        }
        hit |= __ballot_sync(0xffffffffu, mine && sup);
      }
      if (lane == 0) removed[w] |= hit;  // this warp alone owns word w
    }
    __syncthreads();
  }

  for (int j = tid; j < k; j += nthreads)
    keep[base + j] = (kept_w[j >> 5] >> (j & 31)) & 1u;
}

}  // namespace

extern "C" {

int nms_max_k() { return kMaxK; }

// keep (bs, K) uint8 from boxes (bs, K, 4) f32 xyxy in descending-score
// order, cls (bs, K) f32 and valid (bs, K) uint8 (0 or 1). One launch on
// `stream`, no synchronisation; returns the first CUDA error of setting the
// shared-memory limit or of the launch (0 on success). All pointers are
// contiguous device memory.
int nms_greedy_keep(const void* boxes, const void* cls, const void* valid,
                    void* keep, int bs, int k, float iou_threshold,
                    void* stream) {
  if (bs <= 0 || k <= 0) return 0;
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  const int words = (k + 31) / 32;
  const int warps = words < kMaxWarps ? words : kMaxWarps;
  const size_t smem = smem_bytes(words);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_keep_kernel<<<bs, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)cls, (const uint8_t*)valid,
      (uint8_t*)keep, k, iou_threshold);
  return (int)cudaGetLastError();
}

}  // extern "C"
