// Greedy class-aware NMS keep mask for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel yolov5m_tpu/ops/pallas/nms_kernel.py
// (_nms_kernel, entered through greedy_suppress_pallas). Same result: per
// image, over K score-sorted candidates,
//   S[i,j] = IoU(i,j) > t  &&  cls_i == cls_j  &&  j > i
//   keep   = the sequential greedy scan over S, gated by valid
// which is bit-identical to the fixpoint the TPU kernel iterates.
//
// Design (the TPU kernel's bf16 (K,K) VMEM matrix and MXU matvecs are TPU
// choices and are not carried over):
//   phase 1  one warp per (image, row i, 32-column word w): each lane
//            computes one IoU, __ballot_sync packs the 32 decisions into
//            one uint32 of S. S lives in a global scratch of
//            bs*K*ceil(K/32) words (4 MB at bs=128, K=512), which stays in
//            the 50 MB L2 between the two launches.
//   phase 2  one warp per image sweeps the rows in score order. The
//            "removed" bitmask (ceil(K/32) <= 64 words) lives in registers,
//            two words per lane; the owner lane of row i's bit broadcasts
//            it with a shuffle, and a kept row ORs its S words in.
// Bound: phase 1 does K*K/2 useful IoUs per image and writes K*K/8 bytes
// of S; phase 2 is a chain of K dependent steps per image, so at serving
// shapes the kernel is latency-bound, not bound by bytes or flops.
//
// Rounding: the IoU keeps the TPU kernel's operation order
// (area_c + area_r - inter + 1e-7, then divide) with explicitly rounded
// intrinsics, and the file is built with --fmad=false, so no FMA
// contraction changes a decision at IoU == t. The threshold is a float
// and the compare is in f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 2048;
constexpr int kWordsPerLane = 2;  // 2 * 32 lanes * 32 bits = 2048 rows
constexpr int kWarpsPerBlock = 8;
static_assert(kWordsPerLane * 32 * 32 == kMaxK, "removed[] covers kMaxK rows");
static_assert(kWordsPerLane == 2, "the owner-word select assumes two slots");

__global__ void suppress_bits_kernel(const float* __restrict__ boxes,
                                     const float* __restrict__ cls,
                                     uint32_t* __restrict__ smat,
                                     int k, int words, float iou_threshold) {
  const int b = blockIdx.y;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= k * words) return;  // whole warp exits together
  const int i = warp / words;
  const int w = warp - i * words;
  const int j = w * 32 + lane;

  const float* bi = boxes + ((int64_t)b * k + i) * 4;
  const float x1c = bi[0], y1c = bi[1], x2c = bi[2], y2c = bi[3];
  const float clsc = cls[(int64_t)b * k + i];

  bool sup = false;
  if (j < k && j > i) {
    const float* bj = boxes + ((int64_t)b * k + j) * 4;
    const float x1r = bj[0], y1r = bj[1], x2r = bj[2], y2r = bj[3];
    const float area_c = __fmul_rn(__fsub_rn(x2c, x1c), __fsub_rn(y2c, y1c));
    const float area_r = __fmul_rn(__fsub_rn(x2r, x1r), __fsub_rn(y2r, y1r));
    const float iw = fmaxf(__fsub_rn(fminf(x2c, x2r), fmaxf(x1c, x1r)), 0.0f);
    const float ih = fmaxf(__fsub_rn(fminf(y2c, y2r), fmaxf(y1c, y1r)), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    const float denom =
        __fadd_rn(__fsub_rn(__fadd_rn(area_c, area_r), inter), 1e-7f);
    const float iou = __fdiv_rn(inter, denom);
    sup = (iou > iou_threshold) && (clsc == cls[(int64_t)b * k + j]);
  }
  const uint32_t word = __ballot_sync(0xffffffffu, sup);
  if (lane == 0) smat[((int64_t)b * k + i) * words + w] = word;
}

__global__ void greedy_sweep_kernel(const uint32_t* __restrict__ smat,
                                    const uint8_t* __restrict__ valid,
                                    uint8_t* __restrict__ keep, int k,
                                    int words) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint32_t* rows = smat + (int64_t)b * k * words;
  const uint8_t* v = valid + (int64_t)b * k;

  uint32_t removed[kWordsPerLane];
#pragma unroll
  for (int q = 0; q < kWordsPerLane; ++q) removed[q] = 0u;

  for (int i = 0; i < k; ++i) {
    // S row i: lane holds words lane and lane + 32 (0 past the end)
    uint32_t row[kWordsPerLane];
#pragma unroll
    for (int q = 0; q < kWordsPerLane; ++q) {
      const int w = lane + 32 * q;
      row[q] = w < words ? rows[(int64_t)i * words + w] : 0u;
    }
    // row i's "removed" bit is final here (only rows < i set it); its word
    // wi lives in lane wi % 32, slot wi / 32 (a select keeps removed[] in
    // registers)
    const int wi = i >> 5;
    const uint32_t owner_word = (wi >> 5) ? removed[1] : removed[0];
    const uint32_t bits = __shfl_sync(0xffffffffu, owner_word, wi & 31);
    const bool alive = v[i] && !((bits >> (i & 31)) & 1u);
    if (alive) {
#pragma unroll
      for (int q = 0; q < kWordsPerLane; ++q) removed[q] |= row[q];
    }
  }

  // keep = valid & ~removed; each lane writes the rows of its own words
#pragma unroll
  for (int q = 0; q < kWordsPerLane; ++q) {
    const int w = lane + 32 * q;
    for (int bit = 0; bit < 32; ++bit) {
      const int i = w * 32 + bit;
      if (i < k) keep[(int64_t)b * k + i] = v[i] && !((removed[q] >> bit) & 1u);
    }
  }
}

}  // namespace

extern "C" {

int nms_max_k() { return kMaxK; }

// The two phases are two entry points, one launch each, so that the
// caller checks and times each launch on its own. Both launch on `stream`,
// do not synchronise, and return cudaGetLastError() after the launch (0 on
// success). All pointers are contiguous device memory.

// Phase 1: smat (bs, K, ceil(K/32)) uint32 from boxes (bs, K, 4) f32 xyxy
// and cls (bs, K) f32.
int nms_suppress_bits(const void* boxes, const void* cls, void* smat, int bs,
                      int k, float iou_threshold, void* stream) {
  if (bs <= 0 || k <= 0) return 0;
  if (k > kMaxK || bs > 65535) return (int)cudaErrorInvalidValue;
  const int words = (k + 31) / 32;
  const int warps = k * words;
  dim3 grid((warps + kWarpsPerBlock - 1) / kWarpsPerBlock, bs);
  suppress_bits_kernel<<<grid, 32 * kWarpsPerBlock, 0,
                         (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)cls, (uint32_t*)smat, k, words,
      iou_threshold);
  return (int)cudaGetLastError();
}

// Phase 2: keep (bs, K) uint8 from smat (phase 1's output) and valid
// (bs, K) uint8.
int nms_greedy_sweep(const void* smat, const void* valid, void* keep, int bs,
                     int k, void* stream) {
  if (bs <= 0 || k <= 0) return 0;
  if (k > kMaxK || bs > 65535) return (int)cudaErrorInvalidValue;
  greedy_sweep_kernel<<<bs, 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)smat, (const uint8_t*)valid, (uint8_t*)keep, k,
      (k + 31) / 32);
  return (int)cudaGetLastError();
}

}  // extern "C"
