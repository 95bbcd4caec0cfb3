// GRU recurrence with a hand-built copy pipeline (kernel B4), for Hopper
// (sm_90a), in two bodies.
//
// Replaces: vcr_tpu/ops/pallas_gru.py::_gru_seq_dma_kernel, launched by
// gru_sequence_pallas_dma. It computes kernel B1's function (gru_seq.cu):
// x_gates (T, B, 3H) in the compute dtype cd -> out (T, B, H) float32, with
//   hg = cd(h) @ cd(W_hh) + b_hh          (float32 accumulation)
//   r = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
//   h = (1 - z) * n + z * h               (float32 state)
// and has B1's bound: ~0.1 ms at T=30, B=2048, H=512, bf16 on an H100 SXM,
// set by the recurrent products at the bf16 tensor-core rate (96.6 GFLOP,
// 98 us) just above the bytes (x_gates 189 MB + out 126 MB, 94 us).
//
// What makes it B4 is how x_gates and out move. The TPU kernel runs one
// program per batch tile over the whole time loop and copies by hand:
// x_gates for step t+1 is fetched into slot (t+1)%2 while step t computes,
// each output goes out from a slot whose copy is awaited two steps later,
// before the slot is written again, and the float32 h stays on chip. Both
// bodies keep that pipeline, built from Hopper's copy engine (TMA) on
// mbarriers. The wrapper (ops/cuda_gru.py) picks the body by dtype and
// shape alone:
//
// * Tensor-core body (gru_seq_dma_tc_forward): bf16 with H % 128 == 0
//   where the shared-memory budget of its launch plan fits
//   (cuda_gru.dma_tc_plan: H <= 512, up to ~3,900 rows at 7 clusters). Its
//   design is described above gru_seq_dma_tc_kernel.
// * Scalar body (gru_seq_dma_forward): float32, and every other bf16 shape.
//   One block per tile of rows:
//   - in: one thread arms slot s's mbarrier with the byte count
//     (mbarrier.arrive.expect_tx) and issues cp.async.bulk global->shared;
//     every thread waits on the slot's mbarrier before reading it, with the
//     phase parity of that slot's use, (t/2)%2. The copy for step 0 is issued
//     before the loop and none past step T-1, as in the TPU kernel;
//   - out: the threads write h_new into out slot t%2, make those writes
//     visible to the copy engine (fence.proxy.async.shared::cta), meet at a
//     barrier, and one thread issues cp.async.bulk shared->global and commits
//     it as a bulk group. Slot t%2 is written again at step t+2; the store
//     that read it is awaited (cp.async.bulk.wait_group.read) by that thread
//     before the barrier that ends step t+1, which is the counterpart of the
//     TPU kernel's out_dma(slot, t-2).wait(); a final wait_group 0 drains the
//     last store.
//   A tile's rows of one step are one contiguous run of rows*3H (in) and
//   rows*H (out) elements in the time-major layout, so each copy is a single
//   1-D bulk copy, the ragged last tile included. Bulk copies need 16-byte
//   addresses and sizes: H % 8 == 0.
//   The recurrent product and gate math are those of B1's scalar body, in
//   its FMA order and on the same rounded h (float, double-buffered): this
//   body agrees with B1 bit for bit in float32, where B1 runs that body.
//   B1's scalar body keeps a separate float32 h; here the out slot of step
//   t-1 holds exactly that h while step t reads it (its store only reads it
//   too), so the block needs no third copy, and a 16-row tile fits in the
//   227 KB a block may have at H=512 in bf16: 2 x_gates slots 96 KB, 2 out
//   slots 64 KB, 2 rounded h 64 KB. The tile is the largest of 16, 8, 4, 2,
//   1 rows that fits: 16 in bf16 and 8 in float32 at H=512. W_hh streams
//   from L2 every step, as in B1's scalar body.

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRowChoices[] = {16, 8, 4, 2, 1};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// round a float32 value to the compute dtype and back
__device__ __forceinline__ float round_cd(float v, float*) { return v; }
__device__ __forceinline__ float round_cd(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(arrivals) : "memory");
}

// the one arrival of a phase, which also announces the bytes still to land
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed. A copy lands in
// microseconds; a wait on the wrong phase would spin forever, so after about
// ten seconds the kernel traps and the launch fails instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  }
}

// global -> shared; its bytes count against `bar`'s current phase
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// shared -> global, committed as a bulk group of its own
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads)
gru_seq_dma_kernel(const T* __restrict__ xg,        // (T, B, 3H) compute dtype
                   const T* __restrict__ whh,       // (H, 3H) compute dtype
                   const float* __restrict__ bhh,   // (3H,)
                   const float* __restrict__ h0,    // (B, H)
                   float* __restrict__ out,         // (T, B, H)
                   int steps, int batch, int hidden) {
  extern __shared__ float4 smem4[];
  const int h3 = 3 * hidden;
  const int tile = kRows * hidden;
  T* xg_s = reinterpret_cast<T*>(smem4);                            // [2][kRows][3H]
  float* out_s = reinterpret_cast<float*>(xg_s + 2 * kRows * h3);   // [2][kRows][H]
  float* h_c = out_s + 2 * tile;                                     // [2][kRows][H] rounded
  uint64_t* bars = reinterpret_cast<uint64_t*>(h_c + 2 * tile);      // [2] x_gates slots

  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - b0);
  const uint32_t in_bytes = (uint32_t)(rows * h3 * sizeof(T));
  const uint32_t out_bytes = (uint32_t)(rows * hidden * sizeof(float));
  const bool leader = threadIdx.x == 0;

  if (leader) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // h0 goes where step 0 looks for the state of step -1: out slot 1
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i / hidden;
    const float v = r < rows ? h0[(size_t)(b0 + r) * hidden + (i % hidden)] : 0.0f;
    out_s[tile + i] = v;
    h_c[i] = round_cd(v, (T*)nullptr);
  }
  __syncthreads();
  if (leader) {  // step 0's gates
    mbar_arrive_expect_tx(&bars[0], in_bytes);
    bulk_load(xg_s, xg + (size_t)b0 * h3, in_bytes, &bars[0]);
  }

  for (int t = 0; t < steps; ++t) {
    const int slot = t & 1;
    if (leader && t + 1 < steps) {
      // slot ^ 1 was last read in step t-1, which ended at a barrier
      mbar_arrive_expect_tx(&bars[slot ^ 1], in_bytes);
      bulk_load(xg_s + (slot ^ 1) * kRows * h3,
                xg + ((size_t)(t + 1) * batch + b0) * h3, in_bytes, &bars[slot ^ 1]);
    }
    const float* hc_cur = h_c + slot * tile;
    float* hc_next = h_c + (slot ^ 1) * tile;
    const T* x_t = xg_s + slot * kRows * h3;
    const float* h_prev = out_s + (slot ^ 1) * tile;  // float32 h of step t-1
    float* o_t = out_s + slot * tile;
    // the (t/2)-th use of this slot completes the barrier's phase of that parity
    mbar_wait(&bars[slot], (t >> 1) & 1);

    for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
      float acc_r[kRows], acc_z[kRows], acc_n[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc_r[r] = acc_z[r] = acc_n[r] = 0.0f;

      for (int k = 0; k < hidden; k += 4) {
        float wr[4], wz[4], wn[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const T* wrow = whh + (size_t)(k + u) * h3;
          wr[u] = to_f32(wrow[j]);
          wz[u] = to_f32(wrow[hidden + j]);
          wn[u] = to_f32(wrow[2 * hidden + j]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          // every thread of the warp reads the same address: a broadcast
          const float4 hv = *reinterpret_cast<const float4*>(hc_cur + r * hidden + k);
          const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc_r[r] = fmaf(hk[u], wr[u], acc_r[r]);
            acc_z[r] = fmaf(hk[u], wz[u], acc_z[r]);
            acc_n[r] = fmaf(hk[u], wn[u], acc_n[r]);
          }
        }
      }

      const float br = bhh[j], bz = bhh[hidden + j], bn = bhh[2 * hidden + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const T* x = x_t + r * h3;
          const float hr = acc_r[r] + br, hz = acc_z[r] + bz, hn = acc_n[r] + bn;
          const float rg = sigmoid_f(to_f32(x[j]) + hr);
          const float zg = sigmoid_f(to_f32(x[hidden + j]) + hz);
          const float ng = tanhf(to_f32(x[2 * hidden + j]) + rg * hn);
          const float h_new = (1.0f - zg) * ng + zg * h_prev[r * hidden + j];
          hc_next[r * hidden + j] = round_cd(h_new, (T*)nullptr);
          o_t[r * hidden + j] = h_new;
        }
      }
    }

    // this thread's writes to o_t, seen by the bulk store issued below
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    // the store of step t-1 is the leader's only one in flight: once it has
    // read its slot, step t+1 may write that slot again
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    // also: all reads of hc_cur, x_t and h_prev end before they are overwritten
    __syncthreads();
    if (leader) bulk_store(out + ((size_t)t * batch + b0) * hidden, o_t, out_bytes);
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

size_t smem_bytes(int rows, int hidden, size_t elem) {
  // 2 x_gates slots, 2 out slots, 2 rounded h, 2 mbarriers
  return (size_t)rows * hidden * (2 * 3 * elem + 4 * sizeof(float))
         + 2 * sizeof(uint64_t);
}

int pick_rows(int hidden, size_t elem) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
          != cudaSuccess)
    return 0;
  for (int rows : kRowChoices)
    if (smem_bytes(rows, hidden, elem) <= (size_t)limit) return rows;
  return 0;
}

template <typename T, int kRows>
cudaError_t launch_rows(const void* xg, const void* whh, const void* bhh, const void* h0,
                        void* out, int steps, int batch, int hidden,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes(kRows, hidden, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(gru_seq_dma_kernel<T, kRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kRows - 1) / kRows);
  gru_seq_dma_kernel<T, kRows><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xg), static_cast<const T*>(whh),
      static_cast<const float*>(bhh), static_cast<const float*>(h0),
      static_cast<float*>(out), steps, batch, hidden);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xg, const void* whh, const void* bhh, const void* h0,
                   void* out, int steps, int batch, int hidden, cudaStream_t stream) {
  switch (pick_rows(hidden, sizeof(T))) {
    case 16: return launch_rows<T, 16>(xg, whh, bhh, h0, out, steps, batch, hidden, stream);
    case 8: return launch_rows<T, 8>(xg, whh, bhh, h0, out, steps, batch, hidden, stream);
    case 4: return launch_rows<T, 4>(xg, whh, bhh, h0, out, steps, batch, hidden, stream);
    case 2: return launch_rows<T, 2>(xg, whh, bhh, h0, out, steps, batch, hidden, stream);
    case 1: return launch_rows<T, 1>(xg, whh, bhh, h0, out, steps, batch, hidden, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// Tensor-core body (bf16).
//
// The scalar body is bound by its product: 12.6 M FP32 FMAs per block and
// step, with W_hh re-read from L2 by all 128 blocks every step. This body
// takes B1's tensor-core design (gru_seq.cu, tc_common.cuh) and rebuilds
// B4's copy pipeline around it:
//
// * W_hh and the product are B1's. A non-portable cluster of 16 CTAs splits
//   W_hh by columns; CTA `rank` holds the r, z and n columns of its U = H/16
//   units in mma.sync B-fragment order for the whole call (96 KB at H=512).
//   A warp computes a chunk of 16 batch rows with mma.sync m16n8k16 bf16 ->
//   f32, accumulators started at b_hh, n-tile 3g+q = gate q of unit group g,
//   so the gate update stays in registers; the rounded h crosses CTAs
//   through the L2 scratch `hs` in A-fragment order (store_h), behind one
//   cluster barrier per step. The product loop, its order of k-steps and
//   the gate expressions are B1's.
// * One CTA per SM (launch bounds): the copy buffers need the room beside
//   the W_hh slice, 232,448 - 98,304 = 134,144 bytes at H=512. B1's body
//   took the same time at one CTA per SM as at two at B=2048 (PERF.md).
// * The copy pipeline is per warp. A warp owns the chunks c = warp,
//   warp + kWarps, ... and walks its items, one per (step, chunk), step by
//   step.
//   - In: a ring of kSlots x_gates slots (one chunk's 16 rows x 3 gates x U
//     units, 3 KB at H=512), each on its own mbarrier. Before the warp
//     computes item i, lane 0 arms the slot of item i + kSlots - 1
//     (mbarrier.arrive.expect_tx) and issues its TMA load. That slot was
//     last read by item i-1, whose reads into registers ended before a
//     __syncwarp. So the next chunk's gates, or the first chunk's of step
//     t+1, land while this chunk computes and while the cluster waits at its
//     barrier. All lanes wait with the slot's use parity (i / kSlots) & 1.
//     No copy is issued past the warp's last item (the TPU kernel's
//     `t + 1 < t_steps`).
//   - Out and the float32 state: each chunk has one float32 tile in shared
//     memory holding the chunk's h of the last step (h0 before step 0, 0 in
//     rows past the batch): the TPU kernel's h_scratch. A thread reads its
//     h_prev from it and computes; then lane 0 waits until the warp's
//     earlier stores have read their tiles (cp.async.bulk.wait_group.read 0,
//     after the product, so that it costs nothing), the warp meets at a
//     __syncwarp, the threads write h_new in place, fence it for the copy
//     engine (fence.proxy.async.shared::cta) and meet again, and lane 0
//     stores the tile to out[t] and commits it as a bulk group. A final
//     wait_group 0 drains the stores.
//   The TPU kernel double-buffers its out slot because one program computes
//   step t+1 right after step t, while the DMA of step t may still read the
//   slot. Here a chunk's tile is written again one step later, after the
//   warp's other chunks and a cluster barrier, so its store has long
//   finished, and the wait that proves it costs nothing: one tile per chunk
//   is enough, and so is the h_scratch it doubles as.
// * The copies use TMA tensor maps, built on the host with
//   cuTensorMapEncodeTiled (reached through the runtime's driver entry
//   point, so the library needs no -lcuda) and passed as __grid_constant__
//   parameters. Their boxes split H into 8-unit groups, so that a tile lands
//   in an order in which the threads' accesses are free of bank conflicts
//   without a swizzle:
//   - x_gates (T, B, 3H) as {8 units, 3 gates, B, H/8, T}, box
//     {8, 3, 16, U/8, 1}: a slot is [group][row][gate][8 units] bf16, and a
//     warp's 32-bit reads of one (group, gate) fall on words row*12 + tq:
//     32 banks;
//   - out (T, B, H) as {8 units, B, H/8, T}, box {8, 16, U/8, 1}: a tile is
//     [group][row][8 units] float32, and a half-warp's 64-bit reads and
//     writes of one group fall on words row*8 + 2*tq: 32 banks.
//   The plain boxes ({U, 3, 16, 1} and {U, 16, 1}, rows of 192 and 128
//   bytes) put the eight rows gq of a fragment on the same banks 4 ways; a
//   128-byte swizzle brings the out tile only to 2 ways, since its XOR with
//   the row moves whole 16-byte chunks and tq's pair lies inside one. Rows
//   past the batch load as zeros and a store clips them, so the ragged last
//   chunk never writes another step's rows. 1-D bulk copies per row segment
//   (48 in, 16 out per chunk and step) would allow padded rows too, but
//   cost 64 copy instructions where the maps need two.
// * Shared memory per CTA at H=512, B=2048 (7 clusters of 304 rows, 19
//   chunks a CTA): W_hh slice 98,304 + 19 tiles of 2,048 + 10 warps x 2
//   slots of 3,072 + 20 mbarriers = 198,816 of 232,448 bytes. The wrapper's
//   plan checks this budget and gives the scalar body the batches beyond it.
// ---------------------------------------------------------------------------

namespace dma_tc {

using namespace tc;  // kCluster, kChunk and the helpers B1's body uses

// Measured on an H100 (scripts/gru_dma_tc_probe.py, PERF.md): at B=2048 a
// CTA has 19 chunks, so 10 warps carry at most two each (8 warps leave three
// with three); ptxas budgets 10 warps' registers as 12 (168 a thread), where
// A loaded 8 k-steps ahead spills and 4 does not (136). A third ring slot
// gains nothing: one item of look-ahead already hides the copies.
constexpr int kWarps = 10;     // warps per CTA, one CTA per SM
constexpr int kSlots = 2;      // x_gates slots in each warp's ring
constexpr int kThreads = kWarps * 32;
constexpr int kAhead = 4;      // k-steps of A loaded ahead together
constexpr int kMaxGroups = 4;  // H = 128 * groups; 640 and up never fit the budget

// bytes of a CTA's W_hh slice, of one chunk's float32 tile, of one x_gates
// slot, at `groups` 8-unit groups per CTA
constexpr size_t w_bytes(int groups) { return (size_t)6144 * groups * groups; }
constexpr size_t tile_bytes(int groups) { return (size_t)kChunk * 8 * groups * 4; }
constexpr size_t slot_bytes(int groups) { return (size_t)kChunk * 3 * 8 * groups * 2; }

size_t smem_bytes(int groups, int chunks) {
  return w_bytes(groups) + chunks * tile_bytes(groups)
         + kWarps * kSlots * (slot_bytes(groups) + sizeof(uint64_t));
}

// TMA: box `map` at coordinates {c0..c4} into shared memory, its bytes
// counted against `bar`'s current phase
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, int c4, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];"
               :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
                  "r"(c4), "r"(smem_addr(bar))
               : "memory");
}

// TMA: shared memory into box `map` at {c0..c3}, committed as a bulk group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
               " [%0, {%2, %3, %4, %5}], [%1];"
               :: "l"(map), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <int kGroups>
__global__ void __launch_bounds__(kThreads, 1)
gru_seq_dma_tc_kernel(const __grid_constant__ CUtensorMap xg_map,   // x_gates, see above
                      const __grid_constant__ CUtensorMap out_map,  // out, see above
                      const __nv_bfloat16* __restrict__ whh,        // (H, 3H)
                      const float* __restrict__ bhh,                // (3H,)
                      const float* __restrict__ h0,                 // (B, H)
                      uint4* __restrict__ hs,                       // [2][chunks][H/16][32]
                      int steps, int batch, int rows_per_cluster) {
  constexpr int U = 8 * kGroups;       // hidden units of this CTA
  constexpr int H = kCluster * U;
  constexpr int KS = H / 16;           // k-steps of the product
  constexpr int NT = 3 * kGroups;      // n-tiles: 3g+q = gate q of unit group g
  constexpr int KB = KS / kAhead;
  constexpr int kTile = kChunk * U;    // float32 values of a chunk's tile
  constexpr int kSlot = kChunk * 3 * U;  // bf16 values of an x_gates slot
  extern __shared__ __align__(128) uint2 w_s[];  // [KS][NT][32 lanes] B fragments

  const int rank = blockIdx.x % kCluster;
  const int cluster = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma groupID, thread in group
  const int g0 = rank * kGroups;            // first unit group (of 8) of this CTA
  const int unit0 = rank * U + 2 * tq;      // this thread's first unit; group g adds 8g
  const int chunks = rows_per_cluster / kChunk;
  const size_t chunk0 = (size_t)cluster * chunks;
  const size_t parity = (size_t)(gridDim.x / kCluster) * chunks * KS * 32;
  const int row0 = cluster * rows_per_cluster;
  const int row_base = row0 + gq;
  // this warp's chunks and items (one per step and chunk)
  const int mine = warp < chunks ? (chunks - 1 - warp) / kWarps + 1 : 0;
  const int items = steps * mine;

  float* tiles = reinterpret_cast<float*>(w_s + KS * NT * 32);  // [chunks][kGroups][16][8]
  __nv_bfloat16* ring_all = reinterpret_cast<__nv_bfloat16*>(tiles + chunks * kTile);
  __nv_bfloat16* ring = ring_all + warp * kSlots * kSlot;  // [kSlots][kGroups][16][3][8]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_all + kWarps * kSlots * kSlot)
                   + warp * kSlots;

  // the x_gates copy of item j into its slot
  const CUtensorMap* xmap = &xg_map;
  auto load_item = [&](int j) {
    const int s = j % kSlots;
    mbar_arrive_expect_tx(&bars[s], (uint32_t)(kSlot * sizeof(__nv_bfloat16)));
    tma_load_5d(ring + s * kSlot, xmap, 0, 0, row0 + (warp + (j % mine) * kWarps) * kChunk,
                g0, j / mine, &bars[s]);
  };
  if (lane == 0 && mine > 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < kSlots - 1 && j < items; ++j) load_item(j);
  }

  // W_hh columns of this CTA's units, in B-fragment order: element (k, n) of
  // n-tile j goes to lane 4n + (k%8)/2 of fragment [k/16][j], register
  // (k%16)/8, half k%2
  for (int i = threadIdx.x; i < H * NT; i += kThreads) {
    const int g = i % kGroups, q = (i / kGroups) % 3, k = i / NT, kk = k & 15;
    const __nv_bfloat16* src = whh + (size_t)k * 3 * H + q * H + rank * U + 8 * g;
    __nv_bfloat16* dst =
        reinterpret_cast<__nv_bfloat16*>(w_s + ((k >> 4) * NT + 3 * g + q) * 32);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      dst[(4 * n + ((kk & 7) >> 1)) * 4 + (kk >> 3) * 2 + (kk & 1)] = src[n];
  }
  // h0 into the tiles, and rounded into step 0's buffer; rows past the batch
  // hold 0. A thread writes the tile positions it reads later.
  for (int c = warp; c < chunks; c += kWarps) {
    float* tile = tiles + c * kTile;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float v[2][2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row_base + c * kChunk + 8 * hh;
        const float* p = h0 + (size_t)r * H + unit0 + 8 * g;
        v[hh][0] = r < batch ? p[0] : 0.0f;
        v[hh][1] = r < batch ? p[1] : 0.0f;
        *reinterpret_cast<float2*>(tile + (g * kChunk + gq + 8 * hh) * 8 + 2 * tq) =
            make_float2(v[hh][0], v[hh][1]);
      }
      store_h(hs, chunk0 + c, KS, g0 + g, lane, v[0], v[1]);
    }
  }
  cluster_sync();  // also: w_s complete, the mbarriers initialised

  int i = 0;  // this warp's item
  for (int t = 0; t < steps; ++t) {
    const uint4* h_cur = hs + (t & 1) * parity;
    uint4* h_next = hs + ((t + 1) & 1) * parity;
    for (int k = 0; k < mine; ++k, ++i) {
      const int c = warp + k * kWarps;
      const int s = i % kSlots;
      // the slot of item i + kSlots - 1 was last read by item i - 1
      if (lane == 0 && i + kSlots - 1 < items) load_item(i + kSlots - 1);
      float* tile = tiles + c * kTile;
      const __nv_bfloat16* xs = ring + s * kSlot;

      // the gate update's operands first, so that their latency hides
      // behind the product: the float32 h of step t-1 from the tile, then
      // x_gates once its copy has landed
      float hp[kGroups][2][2];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 v = *reinterpret_cast<const float2*>(
              tile + (g * kChunk + gq + 8 * hh) * 8 + 2 * tq);
          hp[g][hh][0] = v.x;
          hp[g][hh][1] = v.y;
        }
      }
      // the (i / kSlots)-th use of slot s completes its phase of that parity
      mbar_wait(&bars[s], (uint32_t)((i / kSlots) & 1));
      uint32_t xw[kGroups][3][2];  // bf16 pairs of x_gates [group][gate][row]
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            xw[g][q][hh] = *reinterpret_cast<const uint32_t*>(
                xs + ((g * kChunk + gq + 8 * hh) * 3 + q) * 8 + 2 * tq);
        }
      }

      // hg = h @ W_hh + b_hh, f32 accumulation; A from L2, B from shared
      float acc[NT][4];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float b0 = __ldg(bhh + q * H + unit0 + 8 * g);
          const float b1 = __ldg(bhh + q * H + unit0 + 8 * g + 1);
          acc[3 * g + q][0] = acc[3 * g + q][2] = b0;
          acc[3 * g + q][1] = acc[3 * g + q][3] = b1;
        }
      }
      const uint4* a_src = h_cur + (chunk0 + c) * KS * 32 + lane;
      uint4 a[2][kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) a[0][j] = __ldcg(a_src + j * 32);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        if (kb + 1 < KB) {
#pragma unroll
          for (int j = 0; j < kAhead; ++j)
            a[(kb + 1) & 1][j] = __ldcg(a_src + ((kb + 1) * kAhead + j) * 32);
        }
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          const uint2* b = w_s + (kb * kAhead + j) * NT * 32 + lane;
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_bf16(acc[n], a[kb & 1][j], b[n * 32]);
        }
      }

      // r, z, n and the new h, in registers
      float hn[kGroups][2][2];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 2 * hh + e;
            const float rg = sigmoid_tc(bf16_at(xw[g][0][hh], e) + acc[3 * g][n]);
            const float zg = sigmoid_tc(bf16_at(xw[g][1][hh], e) + acc[3 * g + 1][n]);
            const float ng = tanh_tc(bf16_at(xw[g][2][hh], e) + rg * acc[3 * g + 2][n]);
            hn[g][hh][e] = (1.0f - zg) * ng + zg * hp[g][hh][e];
          }
        }
        store_h(h_next, chunk0 + c, KS, g0 + g, lane, hn[g][0], hn[g][1]);
      }

      // the warp's earlier stores have read their tiles, this one's of step
      // t-1 among them; then h_new goes into the tile and out to out[t]
      if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      __syncwarp();
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(tile + (g * kChunk + gq + 8 * hh) * 8 + 2 * tq) =
              make_float2(hn[g][hh][0], hn[g][hh][1]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) tma_store_4d(&out_map, tile, 0, row0 + c * kChunk, g0, t);
    }
    // step t's h is written everywhere before step t+1 reads it, and step
    // t's reads of h_cur end before step t+1 overwrites it
    if (t + 1 < steps) cluster_sync();
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// cuTensorMapEncodeTiled, from the driver behind the runtime; null if the
// driver does not have it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// x_gates (T, B, 3H) bf16 as {8, 3, B, H/8, T} with box {8, 3, 16, groups, 1},
// and out (T, B, H) float32 as {8, B, H/8, T} with box {8, 16, groups, 1}
cudaError_t make_maps(CUtensorMap* xg_map, CUtensorMap* out_map, const void* xg,
                      void* out, int steps, int batch, int hidden, int groups) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t h = hidden, b = batch, t = steps;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const cuuint64_t xg_dims[5] = {8, 3, b, h / 8, t};
  const cuuint64_t xg_strides[4] = {h * 2, 3 * h * 2, 16, b * 3 * h * 2};
  const cuuint32_t xg_box[5] = {8, 3, (cuuint32_t)kChunk, (cuuint32_t)groups, 1};
  const cuuint64_t out_dims[4] = {8, b, h / 8, t};
  const cuuint64_t out_strides[3] = {h * 4, 32, b * h * 4};
  const cuuint32_t out_box[4] = {8, (cuuint32_t)kChunk, (cuuint32_t)groups, 1};
  if (encode(xg_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(xg), xg_dims,
             xg_strides, xg_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(out_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, out_dims, out_strides,
             out_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
          != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// the shared memory a block may opt into on the current card; 0 if unknown
int smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
          != cudaSuccess)
    return 0;
  return limit;
}

// opt in to all of a block's shared memory (so the occupancy query and
// every launch see one CTA per SM) and to 16-CTA clusters
template <int kGroups>
cudaError_t prepare(int limit) {
  cudaError_t err = cudaFuncSetAttribute(gru_seq_dma_tc_kernel<kGroups>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(gru_seq_dma_tc_kernel<kGroups>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <int kGroups>
cudaError_t max_clusters(int* n) {
  const int limit = smem_limit();
  if (limit == 0) return cudaErrorInvalidValue;
  cudaError_t err = prepare<kGroups>(limit);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, kThreads, limit, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(n, gru_seq_dma_tc_kernel<kGroups>, &cfg);
}

template <int kGroups>
cudaError_t launch(const void* xg, const void* whh, const void* bhh, const void* h0,
                   void* out, void* hs, int steps, int batch, int clusters,
                   int rows_per_cluster, cudaStream_t stream) {
  const int limit = smem_limit();
  const size_t smem = smem_bytes(kGroups, rows_per_cluster / kChunk);
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  cudaError_t err = prepare<kGroups>(limit);
  if (err != cudaSuccess) return err;
  CUtensorMap xg_map, out_map;
  err = make_maps(&xg_map, &out_map, xg, out, steps, batch, kCluster * 8 * kGroups, kGroups);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(clusters, kThreads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gru_seq_dma_tc_kernel<kGroups>, xg_map, out_map,
                           static_cast<const __nv_bfloat16*>(whh),
                           static_cast<const float*>(bhh), static_cast<const float*>(h0),
                           static_cast<uint4*>(hs), steps, batch, rows_per_cluster);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// unit groups per CTA at this hidden size, or 0 where the body does not apply
int groups_for(int hidden) {
  const int groups = hidden / (8 * kCluster);
  return hidden % (8 * kCluster) == 0 && groups >= 1 && groups <= kMaxGroups ? groups : 0;
}

cudaError_t max_clusters_any(int hidden, int* n) {
  switch (groups_for(hidden)) {
    case 1: return max_clusters<1>(n);
    case 2: return max_clusters<2>(n);
    case 3: return max_clusters<3>(n);
    case 4: return max_clusters<4>(n);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_any(const void* x, const void* w, const void* b, const void* h0,
                       void* out, void* hs, int steps, int batch, int hidden, int clusters,
                       int rows, cudaStream_t s) {
  switch (groups_for(hidden)) {
    case 1: return launch<1>(x, w, b, h0, out, hs, steps, batch, clusters, rows, s);
    case 2: return launch<2>(x, w, b, h0, out, hs, steps, batch, clusters, rows, s);
    case 3: return launch<3>(x, w, b, h0, out, hs, steps, batch, clusters, rows, s);
    case 4: return launch<4>(x, w, b, h0, out, hs, steps, batch, clusters, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dma_tc

}  // namespace

extern "C" {

// Batch rows per block that gru_seq_dma_forward takes at this hidden size
// and dtype on the current card; 0 if not even one row fits.
int gru_seq_dma_rows(int hidden, int is_bf16) {
  return pick_rows(hidden, is_bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// x_gates (T, B, 3H) and w_hh (H, 3H) in bf16 when is_bf16 != 0, else
// float32; b_hh (3H,), h0 (B, H) and out (T, B, H) float32; all contiguous on
// the card, x_gates and out 16-byte aligned, H % 8 == 0. Launches on
// `stream`, does not synchronise, allocates nothing. Returns the cudaError_t
// of the launch (0 on success).
int gru_seq_dma_forward(const void* x_gates, const void* w_hh, const void* b_hh,
                        const void* h0, void* out, int steps, int batch, int hidden,
                        int is_bf16, void* stream) {
  if (steps < 1 || batch < 1 || hidden < 8 || hidden % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x_gates) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch<__nv_bfloat16>(x_gates, w_hh, b_hh, h0, out, steps, batch,
                                           hidden, s)
                   : launch<float>(x_gates, w_hh, b_hh, h0, out, steps, batch, hidden, s));
}

// Clusters of kernel B4's tensor-core body that the current card holds at
// once at this hidden size, one CTA per SM; 0 if none, a negated
// cudaError_t if the query failed.
int gru_seq_dma_tc_clusters(int hidden) {
  int n = 0;
  const cudaError_t err = dma_tc::max_clusters_any(hidden, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// Kernel B4 through the tensor-core body: the contract of
// gru_seq_dma_forward in bf16, with H % 128 == 0, x_gates and out 16-byte
// aligned. hs is a scratch of 2 * clusters * rows_per_cluster * H bf16
// values; `clusters` clusters of 16 CTAs each own rows_per_cluster (a
// multiple of 16) batch rows, clusters * rows_per_cluster >= batch, and
// warps and slots (the plan's warps per CTA and x_gates slots per warp)
// must be the body's own. Launches on `stream`, does not synchronise,
// allocates nothing. Returns the cudaError_t of the launch (0 on success).
int gru_seq_dma_tc_forward(const void* x_gates, const void* w_hh, const void* b_hh,
                           const void* h0, void* out, void* hs, int steps, int batch,
                           int hidden, int clusters, int rows_per_cluster, int warps,
                           int slots, void* stream) {
  if (steps < 1 || batch < 1 || clusters < 1 || rows_per_cluster < tc::kChunk ||
      rows_per_cluster % tc::kChunk != 0 ||
      (long long)clusters * rows_per_cluster < batch || dma_tc::groups_for(hidden) == 0 ||
      warps != dma_tc::kWarps || slots != dma_tc::kSlots ||
      reinterpret_cast<uintptr_t>(x_gates) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)dma_tc::launch_any(x_gates, w_hh, b_hh, h0, out, hs, steps, batch, hidden,
                                 clusters, rows_per_cluster,
                                 static_cast<cudaStream_t>(stream));
}

const char* gru_seq_dma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
