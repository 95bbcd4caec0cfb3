// Fused GRU recurrence over a whole sequence, for Hopper (sm_90a), in two
// layouts of one kernel body.
//
// Replaces: vcr_tpu/ops/pallas_gru.py::_gru_seq_kernel, which also has one
// body with a static time_major flag:
//   gru_seq_forward    -- kernel B1, the time-major form (x_gates (T, B, 3H),
//                         out (T, B, H)), launched by
//                         _run_gru_kernel(time_major=True) under
//                         gru_sequence_pallas;
//   gru_seq_bt_forward -- kernel B3, the batch-major form (x_gates (B, T, 3H),
//                         out (B, T, H)), launched by
//                         _run_gru_kernel(time_major=False) under
//                         gru_sequence_pallas_bt.
// Each row's 3H gate values are contiguous in both layouts, so both read them
// coalesced; only the strides between steps and between rows differ.
//
// Computes, for t = 0..T-1 and every batch row:
//   hg = cd(h) @ cd(W_hh) + b_hh          (float32 accumulation)
//   r = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
//   h = (1 - z) * n + z * h               (float32 state)
// with x_gates = xs @ W_ih + b_ih computed outside the kernel and stored in
// the compute dtype cd (bf16, or float32 in float32 mode). Gate order r, z, n.
//
// Bound at the flagship encoder call (T=30, B=2048, H=512, bf16) on an H100
// SXM (data sheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM), the same for both
// layouts:
//   operations: 2*T*B*H*3H = 96.6 GFLOP -> 98 us at the bf16 tensor-core rate;
//   bytes: x_gates 189 MB (bf16) + outs 126 MB (f32) ~ 315 MB -> 94 us.
// So the least time is ~0.1 ms per call; the prime call has the same shape.
//
// The TPU kernel carries h in scratch memory from one sequential grid step
// to the next; CUDA blocks run in no order, so in both bodies below the time
// loop runs inside the block instead, and the ragged last batch tile is
// masked, so any B >= 1 is valid. Both round h to cd as the left operand of
// the recurrent product, which is what h.astype(compute_dtype) does in the
// TPU kernel, and keep the state itself in float32. The wrapper
// (ops/cuda_gru.py) picks the body by dtype and shape alone:
//
// * Tensor-core body (gru_seq_tc_forward): bf16 with H % 128 == 0 and
//   H <= 768. W_hh stays in shared memory for the whole call, split by
//   columns across a cluster of 16 CTAs, and the recurrent product runs on
//   mma.sync; its design is described above gru_seq_tc_kernel.
// * Scalar body (gru_seq_forward / gru_seq_bt_forward): float32, and bf16
//   shapes the tensor-core body does not take. float32 needs true float32
//   products (TF32 off), which tensor cores do not give. One block owns a
//   tile of kTileB batch rows for the whole sequence; batch rows are
//   independent, so no block needs another block's h. The tile keeps h in
//   shared memory twice: float32 for the gate update, and rounded to cd
//   (stored as float, double-buffered) as the left operand of the product.
//   Each thread owns hidden columns j and computes the three gate columns j,
//   H+j, 2H+j for all rows of the tile with scalar FMAs, streaming W_hh from
//   L2 every step: bound by FMA issue and L2 reads, ~34x the bound above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kTileB = 16;    // batch rows per block
constexpr int kThreads = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// round a float32 value to the compute dtype and back
__device__ __forceinline__ float round_cd(float v, float*) { return v; }
__device__ __forceinline__ float round_cd(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// kTimeMajor: x_gates (T, B, 3H) and out (T, B, H); else (B, T, 3H) and (B, T, H)
template <typename T, bool kTimeMajor>
__global__ void __launch_bounds__(kThreads)
gru_seq_kernel(const T* __restrict__ xg,        // x_gates, compute dtype
               const T* __restrict__ whh,       // (H, 3H) compute dtype
               const float* __restrict__ bhh,   // (3H,)
               const float* __restrict__ h0,    // (B, H)
               float* __restrict__ out,
               int steps, int batch, int hidden) {
  extern __shared__ float4 smem4[];
  float* h_f = reinterpret_cast<float*>(smem4);   // [kTileB][H] float32 state
  float* h_c = h_f + kTileB * hidden;              // [2][kTileB][H] rounded to cd

  const int b0 = blockIdx.x * kTileB;
  const int rows = min(kTileB, batch - b0);
  const int h3 = 3 * hidden;
  const int tile = kTileB * hidden;

  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i / hidden;
    const float v = r < rows ? h0[(size_t)(b0 + r) * hidden + (i % hidden)] : 0.0f;
    h_f[i] = v;
    h_c[i] = round_cd(v, (T*)nullptr);
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const float* hc_cur = h_c + (t & 1) * tile;
    float* hc_next = h_c + ((t + 1) & 1) * tile;
    // step t's first row; the time-major offsets are written as before the
    // batch-major form existed, so that B1's generated code stays the same
    const T* xg_t = xg + (kTimeMajor ? (size_t)t * batch * h3 : (size_t)t * h3);
    float* out_t = out + (kTimeMajor ? (size_t)t * batch * hidden : (size_t)t * hidden);

    for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
      float acc_r[kTileB], acc_z[kTileB], acc_n[kTileB];
#pragma unroll
      for (int r = 0; r < kTileB; ++r) acc_r[r] = acc_z[r] = acc_n[r] = 0.0f;

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
        for (int r = 0; r < kTileB; ++r) {
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
      for (int r = 0; r < kTileB; ++r) {
        if (r < rows) {
          const T* x = xg_t + (kTimeMajor ? (size_t)(b0 + r) * h3
                                          : (size_t)(b0 + r) * steps * h3);
          const float hr = acc_r[r] + br, hz = acc_z[r] + bz, hn = acc_n[r] + bn;
          const float rg = sigmoid_f(to_f32(x[j]) + hr);
          const float zg = sigmoid_f(to_f32(x[hidden + j]) + hz);
          const float ng = tanhf(to_f32(x[2 * hidden + j]) + rg * hn);
          // column j of h_f is read and written by this thread only
          const float h_new = (1.0f - zg) * ng + zg * h_f[r * hidden + j];
          h_f[r * hidden + j] = h_new;
          hc_next[r * hidden + j] = round_cd(h_new, (T*)nullptr);
          out_t[(kTimeMajor ? (size_t)(b0 + r) * hidden
                            : (size_t)(b0 + r) * steps * hidden) + j] = h_new;
        }
      }
    }
    // all reads of hc_cur end before the next step overwrites it
    __syncthreads();
  }
}

template <typename T, bool kTimeMajor>
cudaError_t launch(const void* xg, const void* whh, const void* bhh, const void* h0,
                   void* out, int steps, int batch, int hidden, cudaStream_t stream) {
  const size_t smem = (size_t)3 * kTileB * hidden * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gru_seq_kernel<T, kTimeMajor>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kTileB - 1) / kTileB);
  gru_seq_kernel<T, kTimeMajor><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xg), static_cast<const T*>(whh),
      static_cast<const float*>(bhh), static_cast<const float*>(h0),
      static_cast<float*>(out), steps, batch, hidden);
  return cudaGetLastError();
}

template <bool kTimeMajor>
int forward(const void* x_gates, const void* w_hh, const void* b_hh, const void* h0,
            void* out, int steps, int batch, int hidden, int is_bf16, void* stream) {
  if (steps < 1 || batch < 1 || hidden < 4 || hidden % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch<__nv_bfloat16, kTimeMajor>(x_gates, w_hh, b_hh, h0, out, steps,
                                                       batch, hidden, s)
                   : launch<float, kTimeMajor>(x_gates, w_hh, b_hh, h0, out, steps, batch,
                                               hidden, s));
}

// ---------------------------------------------------------------------------
// Tensor-core body (bf16).
//
// What bounds the scalar body is its recurrent product: 12.6 M FP32 FMAs per
// block and step with W_hh re-read from L2 by every block. Here:
//
// * W_hh stays on chip for the whole call, split by columns across a
//   cluster of kCluster = 16 CTAs. CTA `rank` owns the U = H/16
//   hidden units rank*U .. rank*U+U-1, i.e. their r, z and n columns of W_hh:
//   H x 3U bf16, 96 KB at H=512. It loads them once, into shared memory in
//   the order of mma.sync's B fragments, so that a warp reads each fragment
//   as one conflict-free 256-byte run. The gate math of a unit needs its
//   r, z and n columns, so it stays inside one CTA.
// * Each cluster owns a contiguous run of rows_per_cluster batch rows for
//   all T steps; the clusters are independent (no grid-wide sync), and the
//   wrapper sizes their number by cudaOccupancyMaxActiveClusters, so the
//   whole card works at every serving batch.
// * The product runs on tensor cores: mma.sync m16n8k16 bf16 -> f32. A warp
//   owns a chunk of 16 batch rows and all 3U columns of its CTA: n-tile
//   3g+q holds gate q of units 8g..8g+7, so each thread's accumulators hold
//   r, z and n of the same (row, unit) positions and the gate update runs in
//   registers. The accumulators start at b_hh.
// * h moves between steps through L2. A thread's accumulator positions
//   (rows gq and gq+8 of its chunk, units 2tq and 2tq+1 of an 8-unit group)
//   are exactly the positions of an A fragment's registers in the next
//   step's product. So each thread writes its new h, rounded to bf16, into a
//   scratch `hs` (2 step parities x chunks x H/16 k-steps x 32 lanes, one
//   uint4 each) already in fragment order, and a warp reads a whole k-step
//   of A as one coalesced 512-byte run straight into registers (ld.global.cg,
//   past L1), eight k-steps ahead. One cluster barrier per step
//   (barrier.cluster.arrive.release / wait.acquire) orders those writes
//   before the next step's reads; the scratch is double-buffered by step
//   parity, so that barrier also ends the reads of a buffer before it is
//   written again.
// * The float32 state is read back from out[t-1] (h0 at t=0) by the thread
//   that wrote it, and x_gates for the chunk: both are loaded before the
//   product, so their latency hides behind it, and the gate functions avoid
//   the IEEE division, whose slow-path branch would serialise them.
//
// Shared memory holds only the W_hh slice: 6*H*H/16 bytes, which fits the
// 227 KB a block may have up to H=768. U must be a multiple of 8 (one n-tile
// per gate and unit group): H % 128 == 0.
//
// Measured on an H100 (PERF.md, scripts/gru_tc_probe.py): at H=512 the card
// holds 14 clusters, two CTAs per SM by the launch bounds below (7 with
// one). The product takes ~70% of a step, ~28 clocks per mma.sync per warp.
// A wgmma copy of the product is faster at B=2048 but then waits on A's
// loads from L2; a TMA-fed wgmma pipeline is the next redesign.
// ---------------------------------------------------------------------------

namespace tc {

// kCluster (16 CTAs) and kChunk (16 rows) come from tc_common.cuh
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kAhead = 8;     // k-steps of A loaded ahead together
constexpr int kMaxGroups = 6; // 8-unit groups per CTA: H = 128 * groups <= 768

// kTimeMajor: x_gates (T, B, 3H) and out (T, B, H); else (B, T, 3H), (B, T, H)
// Up to H=512 two CTAs fit an SM (128 registers a thread, no spills), which
// gives each SM twice the warps to hide the latency of A's loads with.
template <int kGroups, bool kTimeMajor>
__global__ void __launch_bounds__(kThreads, kGroups <= 4 ? 2 : 1)
gru_seq_tc_kernel(const __nv_bfloat16* __restrict__ xg,  // x_gates, 4-byte aligned
                  const __nv_bfloat16* __restrict__ whh, // (H, 3H)
                  const float* __restrict__ bhh,         // (3H,)
                  const float* __restrict__ h0,          // (B, H)
                  float* __restrict__ out,
                  uint4* __restrict__ hs,                // [2][chunks][H/16][32]
                  int steps, int batch, int rows_per_cluster) {
  constexpr int U = 8 * kGroups;       // hidden units of this CTA
  constexpr int H = kCluster * U;
  constexpr int KS = H / 16;           // k-steps of the product
  constexpr int NT = 3 * kGroups;      // n-tiles: 3g+q = gate q of unit group g
  constexpr int KB = KS / kAhead;
  extern __shared__ uint2 w_s[];       // [KS][NT][32 lanes] B fragments

  const int rank = blockIdx.x % kCluster;
  const int cluster = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma groupID, thread in group
  const int g0 = rank * kGroups;            // first unit group (of 8) of this CTA
  const int unit0 = rank * U + 2 * tq;      // this thread's first unit; group g adds 8g
  const int chunks = rows_per_cluster / kChunk;
  const size_t chunk0 = (size_t)cluster * chunks;
  const size_t parity = (size_t)(gridDim.x / kCluster) * chunks * KS * 32;
  const int row_base = cluster * rows_per_cluster + gq;

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
  // h0, rounded, into step 0's buffer; rows past the batch hold 0
  for (int c = warp; c < chunks; c += kWarps) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float v[2][2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row_base + c * kChunk + 8 * hh;
        const float* p = h0 + (size_t)r * H + unit0 + 8 * g;
        v[hh][0] = r < batch ? p[0] : 0.0f;
        v[hh][1] = r < batch ? p[1] : 0.0f;
      }
      store_h(hs, chunk0 + c, KS, g0 + g, lane, v[0], v[1]);
    }
  }
  cluster_sync();  // also: w_s complete

  for (int t = 0; t < steps; ++t) {
    const uint4* h_cur = hs + (t & 1) * parity;
    uint4* h_next = hs + ((t + 1) & 1) * parity;
    for (int c = warp; c < chunks; c += kWarps) {
      // the gate update's operands first, so that their latency hides
      // behind the product
      uint32_t xw[kGroups][3][2];  // bf16 pairs of x_gates [group][gate][row]
      float hp[kGroups][2][2];     // float32 h of step t-1 [group][row][unit]
      size_t row[2];
      bool ok[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row_base + c * kChunk + 8 * hh;
        ok[hh] = r < batch;
        row[hh] = kTimeMajor ? (size_t)t * batch + r : (size_t)r * steps + t;
        const __nv_bfloat16* x = xg + row[hh] * 3 * H + unit0;
        const float* h_prev =
            t == 0 ? h0 + (size_t)r * H + unit0
                   : out + (kTimeMajor ? row[hh] - batch : row[hh] - 1) * H + unit0;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
#pragma unroll
          for (int q = 0; q < 3; ++q)
            xw[g][q][hh] = ok[hh] ? __ldg(reinterpret_cast<const unsigned int*>(
                                        x + q * H + 8 * g))
                                  : 0u;
          hp[g][hh][0] = ok[hh] ? h_prev[8 * g] : 0.0f;
          hp[g][hh][1] = ok[hh] ? h_prev[8 * g + 1] : 0.0f;
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
      for (int s = 0; s < kAhead; ++s) a[0][s] = __ldcg(a_src + s * 32);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        if (kb + 1 < KB) {
#pragma unroll
          for (int s = 0; s < kAhead; ++s)
            a[(kb + 1) & 1][s] = __ldcg(a_src + ((kb + 1) * kAhead + s) * 32);
        }
#pragma unroll
        for (int s = 0; s < kAhead; ++s) {
          const uint2* b = w_s + (kb * kAhead + s) * NT * 32 + lane;
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a[kb & 1][s], b[j * 32]);
        }
      }

      // r, z, n and the new h, in registers
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float hn[2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * hh + e;
            const float rg = sigmoid_tc(bf16_at(xw[g][0][hh], e) + acc[3 * g][i]);
            const float zg = sigmoid_tc(bf16_at(xw[g][1][hh], e) + acc[3 * g + 1][i]);
            const float ng = tanh_tc(bf16_at(xw[g][2][hh], e) + rg * acc[3 * g + 2][i]);
            hn[hh][e] = (1.0f - zg) * ng + zg * hp[g][hh][e];
          }
          if (ok[hh])
            *reinterpret_cast<float2*>(out + row[hh] * H + unit0 + 8 * g) =
                make_float2(hn[hh][0], hn[hh][1]);
        }
        store_h(h_next, chunk0 + c, KS, g0 + g, lane, hn[0], hn[1]);
      }
    }
    // step t's h is written everywhere before step t+1 reads it, and step
    // t's reads of h_cur end before step t+1 overwrites it
    if (t + 1 < steps) cluster_sync();
  }
}

constexpr size_t smem_bytes(int groups) {
  return (size_t)(16 * 8 * groups / 16) * (3 * groups) * 32 * sizeof(uint2);
}

template <int kGroups, bool kTimeMajor>
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(gru_seq_tc_kernel<kGroups, kTimeMajor>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(kGroups));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(gru_seq_tc_kernel<kGroups, kTimeMajor>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <int kGroups, bool kTimeMajor>
cudaError_t max_clusters(int* n) {
  cudaError_t err = prepare<kGroups, kTimeMajor>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, kThreads, smem_bytes(kGroups), nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(n, gru_seq_tc_kernel<kGroups, kTimeMajor>, &cfg);
}

template <int kGroups, bool kTimeMajor>
cudaError_t launch(const void* xg, const void* whh, const void* bhh, const void* h0,
                   void* out, void* hs, int steps, int batch, int clusters,
                   int rows_per_cluster, cudaStream_t stream) {
  cudaError_t err = prepare<kGroups, kTimeMajor>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(clusters, kThreads, smem_bytes(kGroups), stream, &attr);
  err = cudaLaunchKernelEx(&cfg, gru_seq_tc_kernel<kGroups, kTimeMajor>,
                           static_cast<const __nv_bfloat16*>(xg),
                           static_cast<const __nv_bfloat16*>(whh),
                           static_cast<const float*>(bhh), static_cast<const float*>(h0),
                           static_cast<float*>(out), static_cast<uint4*>(hs), steps, batch,
                           rows_per_cluster);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// unit groups per CTA at this hidden size, or 0 where the body does not apply
int groups_for(int hidden) {
  const int groups = hidden / (8 * kCluster);
  return hidden % (8 * kCluster) == 0 && groups >= 1 && groups <= kMaxGroups ? groups : 0;
}

template <bool kTimeMajor>
cudaError_t max_clusters_any(int hidden, int* n) {
  switch (groups_for(hidden)) {
    case 1: return max_clusters<1, kTimeMajor>(n);
    case 2: return max_clusters<2, kTimeMajor>(n);
    case 3: return max_clusters<3, kTimeMajor>(n);
    case 4: return max_clusters<4, kTimeMajor>(n);
    case 5: return max_clusters<5, kTimeMajor>(n);
    case 6: return max_clusters<6, kTimeMajor>(n);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kTimeMajor>
cudaError_t launch_any(const void* x, const void* w, const void* b, const void* h0,
                       void* out, void* hs, int steps, int batch, int hidden,
                       int clusters, int rows, cudaStream_t s) {
  switch (groups_for(hidden)) {
    case 1: return launch<1, kTimeMajor>(x, w, b, h0, out, hs, steps, batch, clusters, rows, s);
    case 2: return launch<2, kTimeMajor>(x, w, b, h0, out, hs, steps, batch, clusters, rows, s);
    case 3: return launch<3, kTimeMajor>(x, w, b, h0, out, hs, steps, batch, clusters, rows, s);
    case 4: return launch<4, kTimeMajor>(x, w, b, h0, out, hs, steps, batch, clusters, rows, s);
    case 5: return launch<5, kTimeMajor>(x, w, b, h0, out, hs, steps, batch, clusters, rows, s);
    case 6: return launch<6, kTimeMajor>(x, w, b, h0, out, hs, steps, batch, clusters, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// Kernel B1. x_gates (T, B, 3H) and w_hh (H, 3H) in bf16 when is_bf16 != 0,
// else float32; b_hh (3H,), h0 (B, H) and out (T, B, H) float32; all
// contiguous on the card. Launches on `stream`, does not synchronise,
// allocates nothing. Returns the cudaError_t of the launch (0 on success).
int gru_seq_forward(const void* x_gates, const void* w_hh, const void* b_hh,
                    const void* h0, void* out, int steps, int batch, int hidden,
                    int is_bf16, void* stream) {
  return forward<true>(x_gates, w_hh, b_hh, h0, out, steps, batch, hidden, is_bf16,
                       stream);
}

// Kernel B3: the contract of gru_seq_forward on the batch-major layout,
// x_gates (B, T, 3H) and out (B, T, H).
int gru_seq_bt_forward(const void* x_gates, const void* w_hh, const void* b_hh,
                       const void* h0, void* out, int steps, int batch, int hidden,
                       int is_bf16, void* stream) {
  return forward<false>(x_gates, w_hh, b_hh, h0, out, steps, batch, hidden, is_bf16,
                        stream);
}

// Clusters of the tensor-core body that the current card holds at once, at
// this hidden size, for the time-major (B1) or batch-major (B3) layout; 0 if
// none, a negated cudaError_t if the query failed.
int gru_seq_tc_clusters(int hidden, int time_major) {
  int n = 0;
  const cudaError_t err = time_major ? tc::max_clusters_any<true>(hidden, &n)
                                     : tc::max_clusters_any<false>(hidden, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// Kernels B1 (time_major != 0) and B3 through the tensor-core body: the
// contract of gru_seq_forward / gru_seq_bt_forward in bf16, with
// H % 128 == 0 and H <= 768, x_gates 4-byte aligned. hs is a scratch of
// 2 * clusters * rows_per_cluster * H bf16 values; `clusters` clusters of
// 16 CTAs each own rows_per_cluster (a multiple of 16) batch rows, and
// clusters * rows_per_cluster >= batch. Launches on `stream`, does not
// synchronise, allocates nothing. Returns the cudaError_t of the launch.
int gru_seq_tc_forward(const void* x_gates, const void* w_hh, const void* b_hh,
                       const void* h0, void* out, void* hs, int steps, int batch,
                       int hidden, int clusters, int rows_per_cluster, int time_major,
                       void* stream) {
  if (steps < 1 || batch < 1 || clusters < 1 || rows_per_cluster < tc::kChunk ||
      rows_per_cluster % tc::kChunk != 0 ||
      (long long)clusters * rows_per_cluster < batch || tc::groups_for(hidden) == 0 ||
      reinterpret_cast<uintptr_t>(x_gates) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(time_major
                   ? tc::launch_any<true>(x_gates, w_hh, b_hh, h0, out, hs, steps, batch,
                                          hidden, clusters, rows_per_cluster, s)
                   : tc::launch_any<false>(x_gates, w_hh, b_hh, h0, out, hs, steps, batch,
                                           hidden, clusters, rows_per_cluster, s));
}

const char* gru_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
