// Exact greedy hard-NMS keep mask over score-sorted boxes, batched over images.
//
// Replaces the Pallas TPU kernel dsl_tpu/ops/nms_pallas.py::_nms_kernel
// (entered through pallas_nms_keep). Same function: a kept valid box i
// suppresses every later box j with IoU(i, j) > thr (strict); area is
// max(x2-x1,0)*max(y2-y1,0); the union is floored at 1e-10; invalid boxes
// are never kept and never suppress.
//
// What bounds it on an H100: at B=8, N=2000 the inputs are 272 KB and the
// pairwise IoUs about 16M x ~14 flops, a few microseconds of bytes and of
// f32 issue. The real limit is the greedy recurrence itself: N dependent
// steps per image. The TPU kernel walks them one box at a time over the
// whole row; a step here must not cost a device-memory round trip or a
// block-wide barrier.
//
// Design:
//  - Mask pass, grid (ceil(N/64), ceil(N/64), B), upper-triangular tiles
//    only: a block stages 64 column boxes in shared memory; thread t owns row
//    i = 64*row_block + t and writes one uint64 word whose bit k says "row i
//    suppresses column 64*col_block + k" (j > i, IoU > thr). All IoUs are
//    computed in parallel; validity is not looked at here.
//  - Scan pass, one block per image, the "removed" bitmask (ceil(N/64)
//    words) in shared memory. Rows go in chunks of 64: the block copies the
//    chunk's mask rows into shared memory, then ONE thread walks the 64 rows
//    against the chunk's own removed word in registers (each step a shared
//    load and a few integer ops, no barrier), then the threads OR the kept
//    rows into the later words in parallel. That is ceil(N/64) barriers per
//    image instead of N, and the serial part never touches device memory.
//
// Bit-identical keeps with the TPU kernel and with nms_keep_reference need
// the same rounding: products and sums are written with the _rn intrinsics,
// which are never contracted into FMAs (the build adds -fmad=false besides),
// the union is (area_j + area_i) - inter, and the division is IEEE.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f), fmaxf(__fsub_rn(y2, y1), 0.0f));
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n, int col_blocks,
                                float thr, unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  const int b = blockIdx.z;
  if (row_block > col_block) return;  // only words at or after a row's own block are read

  __shared__ float cx1[kTile], cy1[kTile], cx2[kTile], cy2[kTile], carea[kTile];
  const float* img = boxes + static_cast<size_t>(b) * n * 4;
  const int t = threadIdx.x;
  const int col_start = col_block * kTile;
  const int cols = min(n - col_start, kTile);
  if (t < cols) {
    const float4 c = reinterpret_cast<const float4*>(img)[col_start + t];
    cx1[t] = c.x; cy1[t] = c.y; cx2[t] = c.z; cy2[t] = c.w;
    carea[t] = box_area(c.x, c.y, c.z, c.w);
  }
  __syncthreads();

  const int i = row_block * kTile + t;
  if (i >= n) return;
  const float4 p = reinterpret_cast<const float4*>(img)[i];
  const float parea = box_area(p.x, p.y, p.z, p.w);
  unsigned long long bits = 0ULL;
  const int start = (row_block == col_block) ? t + 1 : 0;
  for (int k = start; k < cols; ++k) {
    const float iw = fmaxf(__fsub_rn(fminf(cx2[k], p.z), fmaxf(cx1[k], p.x)), 0.0f);
    const float ih = fmaxf(__fsub_rn(fminf(cy2[k], p.w), fmaxf(cy1[k], p.y)), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = fmaxf(__fsub_rn(__fadd_rn(carea[k], parea), inter), 1e-10f);
    if (__fdiv_rn(inter, uni) > thr) bits |= 1ULL << k;
  }
  mask[(static_cast<size_t>(b) * n + i) * col_blocks + col_block] = bits;
}

// Dynamic shared memory: removed[col_blocks] then rows[kTile][col_blocks].
__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid, int n, int col_blocks,
                                uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;
  unsigned long long* rows = smem + col_blocks;
  __shared__ unsigned long long kept_bits;
  __shared__ unsigned int valid_words[kTile / 32];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const unsigned long long* img_mask = mask + static_cast<size_t>(b) * n * col_blocks;
  const uint8_t* img_valid = valid + static_cast<size_t>(b) * n;
  uint8_t* img_keep = keep + static_cast<size_t>(b) * n;

  for (int w = t; w < col_blocks; w += blockDim.x) removed[w] = 0ULL;

  for (int c = 0; c < col_blocks; ++c) {
    const int row0 = c * kTile;
    const int nrows = min(n - row0, kTile);
    const int width = col_blocks - c;  // a row of chunk c is read from word c on
    for (int e = t; e < nrows * width; e += blockDim.x) {
      const int r = e / width;
      const int w = c + e % width;
      rows[r * col_blocks + w] = img_mask[static_cast<size_t>(row0 + r) * col_blocks + w];
    }
    // the block is exactly kTile threads: one ballot per warp packs the
    // chunk's validity into bits
    const unsigned int ballot = __ballot_sync(0xffffffffu, t < nrows && img_valid[row0 + t]);
    if ((t & 31) == 0) valid_words[t >> 5] = ballot;
    __syncthreads();

    if (t == 0) {
      const unsigned long long vbits =
          valid_words[0] | (static_cast<unsigned long long>(valid_words[1]) << 32);
      unsigned long long rem = removed[c];
      unsigned long long kept = 0ULL;
      for (int r = 0; r < nrows; ++r) {
        if (((vbits & ~rem) >> r) & 1ULL) {
          kept |= 1ULL << r;
          rem |= rows[r * col_blocks + c];
        }
      }
      removed[c] = rem;
      kept_bits = kept;
    }
    __syncthreads();

    const unsigned long long kept = kept_bits;
    for (int w = c + 1 + t; w < col_blocks; w += blockDim.x) {
      unsigned long long acc = removed[w];
      for (int r = 0; r < nrows; ++r) {
        if ((kept >> r) & 1ULL) acc |= rows[r * col_blocks + w];
      }
      removed[w] = acc;
    }
    if (t < nrows) img_keep[row0 + t] = static_cast<uint8_t>((kept >> t) & 1ULL);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes (B, N, 4) f32, valid (B, N) bool as bytes, mask scratch (B, N,
// ceil(N/64)) uint64, keep (B, N) bool as bytes; all contiguous on one card.
// Both passes go on `stream`; nothing synchronises.
cudaError_t nms_keep_launch(const float* boxes, const uint8_t* valid,
                            unsigned long long* mask, uint8_t* keep, int batch, int n,
                            float thr, cudaStream_t stream) {
  const int col_blocks = (n + kTile - 1) / kTile;
  nms_mask_kernel<<<dim3(col_blocks, col_blocks, batch), kTile, 0, stream>>>(
      boxes, n, col_blocks, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // removed[col_blocks] + rows[kTile][col_blocks]; past the card's 227 KB
  // (N of about 28k) the attribute call or the launch is refused
  const size_t smem = static_cast<size_t>(kTile + 1) * col_blocks * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nms_scan_kernel<<<batch, kTile, smem, stream>>>(mask, valid, n, col_blocks, keep);
  return cudaGetLastError();
}

}  // extern "C"
