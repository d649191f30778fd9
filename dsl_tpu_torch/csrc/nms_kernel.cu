// Exact greedy hard-NMS keep mask over score-sorted boxes, batched over images.
//
// Replaces the Pallas TPU kernel dsl_tpu/ops/nms_pallas.py::_nms_kernel
// (entered through pallas_nms_keep). Same function: a kept valid box i
// suppresses every later box j with IoU(i, j) > thr (strict); area is
// max(x2-x1,0)*max(y2-y1,0); the union is floored at 1e-10; invalid boxes
// are never kept and never suppress.
//
// What bounds it on an H100: at B=8, N=2000 the inputs are 272 KB and the
// IoU tests that the data needs a few million, a few microseconds of bytes
// and of f32 work. The real limit is the greedy chain itself: each image's
// keeps depend on each other in score order, so one block per image walks
// them, on at most B of the 132 SMs (one SM for a single request). The
// chain's cost is what the design cuts; every other part is spread over the
// card or hidden behind the chain.
//
// Layout: the suppression mask is chunk-major, (B, C, C, 64) uint64 with
// C = ceil(N/64): mask[b][c][w][r] holds bit k set when row 64c+r suppresses
// column 64w+k (k > r, IoU > thr). The words w = c..C-1 that chunk c needs
// are one contiguous run of (C-c)*512 bytes, which the scan reads as such;
// words w < c are never written or read.
//
// Mask pass: one block of 256 threads for each column tile and each group
// of 4 row tiles at or above it (a linear grid over the upper triangle, so
// no block exits at once). The block stages the 64 column boxes in shared
// memory; thread t owns one row, tests all 64 columns unrolled and writes
// one word, masked to k > r on the diagonal tile. An invalid row writes a
// zero word and tests nothing. The IEEE division runs only where the
// quotient lies within about 2^-20 of thr (see nms_mask_kernel).
//
// Scan pass: one block per image, three roles, no block-wide barrier after
// the prologue. An mbarrier wait costs far more than a shared-memory load,
// so only the bulk copies' arrival goes through mbarriers; the roles hand
// on everything else through counters in shared memory (release/acquire).
//  - The walker warp takes chunk c's candidates, ~removed[c] ("removed"
//    starts as the invalid rows and the rows past N). One warp-wide OR of
//    the candidates' diagonal words finds the candidates that another
//    candidate could suppress; the rest are kept for sure, a second OR
//    removes the rows those suppress, and the warp walks only what is left,
//    lowest bit first (__ffsll), one shuffle a step. A chunk costs as many
//    serial steps as it has candidates whose fate depends on the chain, and
//    none when no two candidates overlap. The walker reads words c..c+2 of
//    its rows straight from device memory, two chunks ahead, publishes the
//    kept bits, writes the chunk's 64 keep bytes and ORs the kept rows into
//    words c+1 and c+2 itself (a register carry), so it runs three chunks
//    ahead of the ORs it needs and waits only for chunk c-3's.
//  - A producer warp streams words c+3..C-1 of each chunk in slabs of
//    64 rows x 32 words (16 KB: a whole chunk's run up to N = 2048) through
//    a ring of 8 slabs with cp.async.bulk (1-D TMA), each completing on its
//    slot's mbarrier (expect_tx bytes).
//  - 4 OR warps take the chunks in turn, so up to four are in flight. For
//    chunk c, lane l ORs the kept rows of word l of each slab, reading the
//    rows in a rotated order that keeps the 32 lanes off each other's
//    banks, and ORs the result into removed atomically: no cross-lane
//    reduction at all.
// Shared memory is the ring (128 KB) plus 8*C bytes, so N is bounded by the
// B*C*C*512-byte scratch, not by the SM.
//
// The scan is launched with programmatic dependent launch: its launch and
// barrier set-up overlap the mask pass's tail, and griddepcontrol.wait holds
// its first read of the mask until the mask grid is done. The first copies
// and the walker's first loads are then in flight while the valid bits are
// gathered.
//
// Bit-identical keeps with the TPU kernel and with nms_keep_reference need
// the same rounding: products and sums are written with the _rn intrinsics,
// which are never contracted into FMAs (the build adds -fmad=false besides),
// the union is (area_j + area_i) - inter, and the division is IEEE.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;                            // rows of a chunk, bits of a word
constexpr int kRowTiles = 4;                         // row tiles of a mask block
constexpr int kMaskThreads = kTile * kRowTiles;
constexpr int kOrWarps = 4;                          // warps 0-3 OR kept rows into words
constexpr int kWalkerWarp = kOrWarps;                // warp 4 walks the chain
constexpr int kProducerWarp = kOrWarps + 1;          // warp 5 starts the bulk copies
constexpr int kScanThreads = (kOrWarps + 2) * 32;
constexpr int kCarry = 2;                            // words after its own the walker ORs itself;
                                                     // with one, the walker waits on chunk c-2's
                                                     // ORs and the scan takes 0.021 ms, not
                                                     // 0.016 (H100 SXM, B=8, N=2000)
constexpr int kHead = 2 * (kCarry + 1);              // u64 a walker lane holds per chunk
constexpr int kSlots = 8;                            // per-chunk hand-over slots, > kCarry + 1
constexpr int kSlabWords = 32;                       // one word per lane: 16 KB, a whole
                                                     // chunk's run up to N = 2048
constexpr int kRing = 8;                             // slabs in flight
constexpr int kSlabU64 = kSlabWords * kTile;
constexpr unsigned kSpinLimit = 1u << 26;            // a lost copy or flag traps, never hangs
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f), fmaxf(__fsub_rn(y2, y1), 0.0f));
}

// The intersection and the floored union of column box c and row box p.
__device__ __forceinline__ void overlap(float4 c, float carea, float4 p, float parea,
                                        float& inter, float& uni) {
  const float iw = fmaxf(__fsub_rn(fminf(c.z, p.z), fmaxf(c.x, p.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(c.w, p.w), fmaxf(c.y, p.y)), 0.0f);
  inter = __fmul_rn(iw, ih);
  uni = fmaxf(__fsub_rn(__fadd_rn(carea, parea), inter), 1e-10f);
}

// The mask pass decides inter / uni > thr as __fdiv_rn(inter, uni) > thr
// would, mostly without dividing. uni >= 1e-10 > 0. thr_lo and thr_hi are
// thr * (1 -+ 2^-20) rounded outward when 2^-20 <= thr < 1 (the products
// below are then normal f32 numbers, so each rounds with a relative error
// of at most 2^-24), else -inf and +inf, which leaves every test to the
// division.
//  - inter > fl(thr_hi * uni) gives q = inter / uni > thr_hi * (1 - 2^-24)
//    >= thr * (1 + 2^-20) * (1 - 2^-24) > thr * (1 + 2^-24), past the
//    midpoint between thr and the next float (one ulp of thr is at most
//    thr * 2^-23), so fl(q) > thr.
//  - inter < fl(thr_lo * uni) gives q < thr_lo * (1 + 2^-24) < thr, so
//    fl(q) <= thr.
// Only the rest, q within about 2^-20 of thr, takes the IEEE division,
// after the loop. NaN fails both tests and the division's compare alike.
// So every bit is the division's.
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid, int n,
                int chunks, float thr, float thr_lo, float thr_hi, u64* __restrict__ mask) {
  // blockIdx.x -> (row group g, column tile cb >= kRowTiles * g); group g
  // has chunks - kRowTiles * g column tiles
  const int linear = blockIdx.x;
  int g = 0, first = 0;
  while (first + chunks - kRowTiles * g <= linear) {
    first += chunks - kRowTiles * g;
    ++g;
  }
  const int cb = kRowTiles * g + (linear - first);
  const int b = blockIdx.y;

  // columns past n are zero boxes: they overlap nothing, and their bits are
  // masked off besides
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  const float4* img = reinterpret_cast<const float4*>(boxes) + static_cast<size_t>(b) * n;
  const int t = threadIdx.x;
  const int col_start = cb * kTile;
  const int cols = min(n - col_start, kTile);
  if (t < kTile) {
    const float4 c = (t < cols) ? img[col_start + t] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    cbox[t] = c;
    carea[t] = box_area(c.x, c.y, c.z, c.w);
  }
  __syncthreads();

  const int rb = kRowTiles * g + t / kTile;
  const int r = t % kTile;
  const int i = rb * kTile + r;
  if (rb > cb || i >= n) return;
  u64 bits = 0ULL;
  if (valid[static_cast<size_t>(b) * n + i]) {
    const float4 p = img[i];
    const float parea = box_area(p.x, p.y, p.z, p.w);
    // all 64 columns unrolled and without a branch; the diagonal tile's
    // k <= r and the columns past n are masked off after
    u64 unsure = 0ULL;
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      float inter, uni;
      overlap(cbox[k], carea[k], p, parea, inter, uni);
      const bool over = inter > __fmul_rn(thr_hi, uni);
      const bool under = inter < __fmul_rn(thr_lo, uni);
      bits |= over ? (1ULL << k) : 0ULL;
      unsure |= (over || under) ? 0ULL : (1ULL << k);
    }
    while (unsure) {
      const int k = __ffsll(static_cast<long long>(unsure)) - 1;
      unsure &= unsure - 1ULL;
      float inter, uni;
      overlap(cbox[k], carea[k], p, parea, inter, uni);
      if (__fdiv_rn(inter, uni) > thr) bits |= 1ULL << k;
    }
    if (cols < kTile) bits &= (1ULL << cols) - 1ULL;
    if (rb == cb) bits &= ~((2ULL << r) - 1ULL);  // r == 63 gives 0: nothing after
  }
  mask[((static_cast<size_t>(b) * chunks + rb) * chunks + cb) * kTile + r] = bits;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  for (unsigned spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > kSpinLimit) __trap();
  }
}

// bytes from global src to shared dst, counted on bar's transaction count;
// both addresses and bytes are multiples of 16
__device__ __forceinline__ void bulk_copy(u64* dst, const u64* src, unsigned bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Progress counters between the warps: plain shared words, written with
// release and read with acquire, so what a warp wrote before a count is
// seen by the warp that read the count. A poll is one shared load.
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];" : "=r"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(smem_u32(p)), "r"(v) : "memory");
}

__device__ __forceinline__ void wait_count(const unsigned* counter, unsigned target) {
  for (unsigned spins = 0; ld_acquire(counter) < target; ++spins)
    if (spins > kSpinLimit) __trap();
}

__device__ __forceinline__ u64 warp_or(u64 x) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x));
  const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

// OR over the rows of `rows` (bit r = row r) of their words; lane l holds
// the words of rows l and l + 32
__device__ __forceinline__ u64 or_of_rows(u64 rows, u64 word_lo, u64 word_hi, int lane) {
  const u64 x = (((rows >> lane) & 1ULL) ? word_lo : 0ULL) |
                (((rows >> (lane + 32)) & 1ULL) ? word_hi : 0ULL);
  return warp_or(x);
}

// Words c..c+kCarry of chunk c's rows (lane l: rows l and l + 32), straight
// from device memory; zero past the end.
__device__ __forceinline__ void load_chunk_head(const u64* img_mask, int chunks, int c, int lane,
                                                u64 (&x)[kHead]) {
  const u64* run = img_mask + (static_cast<size_t>(c) * chunks + c) * kTile;
#pragma unroll
  for (int j = 0; j <= kCarry; ++j) {
    const bool in = c + j < chunks;
    x[2 * j] = in ? run[j * kTile + lane] : 0ULL;
    x[2 * j + 1] = in ? run[j * kTile + lane + 32] : 0ULL;
  }
}

// Dynamic shared memory: ring[kRing][kSlabWords][kTile] then removed[chunks].
__global__ void __launch_bounds__(kScanThreads, 1)
nms_scan_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid, int n,
                int chunks, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  u64* ring = reinterpret_cast<u64*>(smem_raw);
  u64* removed = ring + kRing * kSlabU64;
  __shared__ u64 full[kRing];            // a slab landed (expect_tx bytes)
  __shared__ u64 kept_ring[kSlots];      // chunk c's kept rows in slot c % kSlots
  __shared__ unsigned kept_count;        // chunks the walker has published
  __shared__ unsigned chunk_done[kSlots];  // c + 1 once chunk c's ORs are in
  __shared__ unsigned slab_done[kRing];    // s + 1 once slab s is read

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const uint8_t* img_valid = valid + static_cast<size_t>(b) * n;
  uint8_t* img_keep = keep + static_cast<size_t>(b) * n;
  const u64* img_mask = mask + static_cast<size_t>(b) * chunks * chunks * kTile;

  if (t == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    kept_count = 0;
  }
  if (t < kSlots) chunk_done[t] = 0;
  if (t < kRing) slab_done[t] = 0;
  __syncthreads();
  // the mask is the mask pass's output (programmatic dependent launch)
  asm volatile("griddepcontrol.wait;" ::: "memory");

  if (warp == kProducerWarp) {
    // words c+kCarry+1..C-1 of every chunk, in order; a slot is refilled
    // once the slab it held has been read
    if (lane == 0) {
      int seq = 0;
      for (int c = 0; c < chunks; ++c) {
        for (int w0 = c + kCarry + 1; w0 < chunks; w0 += kSlabWords, ++seq) {
          const int slot = seq % kRing;
          if (seq >= kRing) {
            wait_count(&slab_done[slot], seq - kRing + 1);
            // the reads of the slot come before the copy's writes
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          }
          const unsigned bytes = min(kSlabWords, chunks - w0) * kTile * sizeof(u64);
          mbar_arrive_expect_tx(&full[slot], bytes);
          bulk_copy(ring + slot * kSlabU64,
                    img_mask + (static_cast<size_t>(c) * chunks + w0) * kTile, bytes, &full[slot]);
        }
      }
    }
    return;
  }

  // the walker's first two chunk heads are in flight while the ballots run
  u64 cur[kHead], nxt[kHead];
  if (warp == kWalkerWarp) {
    load_chunk_head(img_mask, chunks, 0, lane, cur);
    load_chunk_head(img_mask, chunks, 1, lane, nxt);
  }
  // rows that are no candidate: invalid, or past n; one ballot per 32 rows,
  // sixteen rounds of loads in flight together
  constexpr int kWorkers = kOrWarps + 1;
  for (int h0 = warp; h0 < 2 * chunks; h0 += 16 * kWorkers) {
    bool ok[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int row = (h0 + m * kWorkers) * 32 + lane;
      ok[m] = row < n && img_valid[row];
    }
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const unsigned bits = __ballot_sync(0xffffffffu, ok[m]);
      const int h = h0 + m * kWorkers;
      if (lane == 0 && h < 2 * chunks) reinterpret_cast<unsigned*>(removed)[h] = ~bits;
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kWorkers * 32) : "memory");

  if (warp == kWalkerWarp) {
    // chunk c needs removed[c] with the ORs of every chunk before it: those
    // of chunks c-kCarry..c-1 come in carry[0] from this warp (carry[j] holds
    // them for word c+j), the others from the OR warps. Chunks finish in any
    // order; the walker checks them one by one, chunk c-kCarry-1 at chunk c.
    u64 carry[kCarry] = {};
    for (int c = 0; c < chunks; ++c) {
      u64 fut[kHead];
      load_chunk_head(img_mask, chunks, c + 2, lane, fut);
      if (c > kCarry) wait_count(&chunk_done[(c - kCarry - 1) % kSlots], c - kCarry);
      const u64 cand = ~(removed[c] | carry[0]);
      const u64 contested = or_of_rows(cand, cur[0], cur[1], lane) & cand;
      u64 kept = cand & ~contested;
      if (contested) {
        u64 rest = contested & ~or_of_rows(kept, cur[0], cur[1], lane);
        while (rest) {  // warp-uniform; row r's diagonal word comes from lane r % 32
          const int r = __ffsll(static_cast<long long>(rest)) - 1;
          const u64 diag = __shfl_sync(0xffffffffu, r < 32 ? cur[0] : cur[1], r & 31);
          kept |= 1ULL << r;
          rest &= ~diag;
          rest &= rest - 1ULL;  // row r itself
        }
      }
      if (lane == 0) {
        kept_ring[c % kSlots] = kept;
        st_release(&kept_count, c + 1);
      }
      const int row0 = c * kTile;
      if (row0 + lane < n) img_keep[row0 + lane] = static_cast<uint8_t>((kept >> lane) & 1ULL);
      if (row0 + lane + 32 < n)
        img_keep[row0 + lane + 32] = static_cast<uint8_t>((kept >> (lane + 32)) & 1ULL);
#pragma unroll
      for (int j = 0; j < kCarry; ++j) {
        const u64 older = j + 1 < kCarry ? carry[j + 1] : 0ULL;
        carry[j] = older | or_of_rows(kept, cur[2 * j + 2], cur[2 * j + 3], lane);
      }
#pragma unroll
      for (int q = 0; q < kHead; ++q) {
        cur[q] = nxt[q];
        nxt[q] = fut[q];
      }
    }
    return;
  }

  // OR warps: warp k takes chunks k, k+4, ..., so several chunks are in
  // flight at once. Chunk c's kept rows go into words c+kCarry+1..C-1 (the
  // words before are the walker's carry). Lane l owns word l of a slab and
  // reads row (l + i) % 64 at step i: the 32 lanes hit 16 different bank
  // pairs twice, so no load conflicts and no cross-lane reduction. Two
  // chunks may OR into one word at once, so the OR into removed is atomic.
  int seq = 0;
  for (int c = 0; c < chunks; ++c) {
    const int w_first = c + kCarry + 1;
    const int slabs = w_first < chunks ? (chunks - w_first + kSlabWords - 1) / kSlabWords : 0;
    if (c % kOrWarps != warp) {
      seq += slabs;
      continue;
    }
    if (slabs > 0) {
      wait_count(&kept_count, c + 1);
      const u64 kept = kept_ring[c % kSlots];
      for (int w0 = w_first; w0 < chunks; w0 += kSlabWords, ++seq) {
        const int slot = seq % kRing;
        // the slot's last use is read, so its barrier is at this use's phase
        if (seq >= kRing) wait_count(&slab_done[slot], seq - kRing + 1);
        mbar_wait(&full[slot], (seq / kRing) & 1);
        if (kept != 0ULL) {
          const u64* word = ring + slot * kSlabU64 + lane * kTile;
          u64 acc = 0ULL;
#pragma unroll 16
          for (int i = 0; i < kTile; ++i) {
            const int r = (lane + i) & (kTile - 1);
            const u64 v = word[r];
            acc |= ((kept >> r) & 1ULL) ? v : 0ULL;
          }
          if (w0 + lane < chunks && acc != 0ULL) atomicOr(&removed[w0 + lane], acc);
        }
        __syncwarp();
        if (lane == 0) st_release(&slab_done[slot], seq + 1);
      }
    }
    __syncwarp();
    if (lane == 0) st_release(&chunk_done[c % kSlots], c + 1);
  }
}

// The scan's dynamic shared memory is over the 48 KB default: allow it the
// most a block of this device may opt in to, once per device, so a launch
// makes no attribute call.
cudaError_t allow_scan_smem() {
  static std::atomic<bool> allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && allowed[dev].load())) return err;
  int most = 0;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, nms_scan_kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most - static_cast<int>(fa.sharedSizeBytes));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev].store(true);
  return err;
}

}  // namespace

extern "C" {

// boxes (B, N, 4) f32, valid (B, N) bool as bytes, mask scratch (B, C, C,
// 64) uint64 with C = ceil(N/64) and 16-byte aligned, keep (B, N) bool as
// bytes; all contiguous on one card. Both passes go on `stream`; nothing
// synchronises. Returns the first error.
cudaError_t nms_keep_launch(const float* boxes, const uint8_t* valid, u64* mask, uint8_t* keep,
                            int batch, int n, float thr, cudaStream_t stream) {
  const int chunks = (n + kTile - 1) / kTile;
  long long tiles = 0;
  for (int g = 0; g * kRowTiles < chunks; ++g) tiles += chunks - kRowTiles * g;
  float thr_lo = -INFINITY, thr_hi = INFINITY;  // no shortcut: every test divides
  if (thr >= 0x1p-20f && thr < 1.0f) {
    thr_lo = nextafterf(static_cast<float>(static_cast<double>(thr) * (1.0 - 0x1p-20)), 0.0f);
    thr_hi = nextafterf(static_cast<float>(static_cast<double>(thr) * (1.0 + 0x1p-20)), INFINITY);
  }
  nms_mask_kernel<<<dim3(static_cast<unsigned>(tiles), batch), kMaskThreads, 0, stream>>>(
      boxes, valid, n, chunks, thr, thr_lo, thr_hi, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_scan_smem();
  if (err != cudaSuccess) return err;
  const size_t smem = (static_cast<size_t>(kRing) * kSlabU64 + chunks) * sizeof(u64);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch);
  cfg.blockDim = dim3(kScanThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_scan_kernel, static_cast<const u64*>(mask), valid, n, chunks,
                           keep);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
