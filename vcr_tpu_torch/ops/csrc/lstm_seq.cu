// Fused LSTM recurrence over a whole sequence, time-major, either direction,
// for Hopper (sm_90a).
//
// Replaces: vcr_tpu/ops/pallas_gru.py::_lstm_seq_kernel (launched by
// _lstm_pallas_ad under lstm_sequence_pallas and bilstm_sequence_pallas).
//
// Computes, for every batch row and t = 0..T-1 (T-1..0 when reverse != 0):
//   hg = cd(h) @ cd(W_hh) + b_hh          (float32 accumulation)
//   i = sigmoid(xi + hi); f = sigmoid(xf + hf); g = tanh(xg + hg);
//   o = sigmoid(xo + ho); c = f * c + i * g; h = o * tanh(c)
// with x_gates = xs @ W_ih + b_ih computed outside the kernel and stored in
// the compute dtype cd (bf16, or float32 in float32 mode). Gate order
// i, f, g, o. Each step's h is written at its own time index t, and c after
// the last step is written once to c_last.
//
// Bound at the RationaleNet serving call (one direction, T=30, B=1024,
// H=512, bf16) on an H100 SXM (data sheet: 989 TFLOP/s bf16 dense,
// 3.35 TB/s HBM):
//   operations: 2*T*B*H*4H = 64.4 GFLOP -> 65 us at the bf16 tensor-core rate;
//   bytes: x_gates 126 MB (bf16) + outs 63 MB (f32) + W_hh, h0, c0, c_last
//   ~ 197 MB -> 59 us.
// So the least time is ~0.07 ms per direction, bound by operations.
//
// The TPU kernel carries (h, c) in scratch memory from one sequential grid
// step to the next and gets the reverse direction from its index maps; CUDA
// blocks run in no order, so in both bodies below the time loop runs inside
// the block, and the direction is only which row of x_gates and out step s
// reads and writes (t = reverse ? T-1-s : s). Both round h to cd as the left
// operand of the recurrent product, which is what h.astype(compute_dtype)
// does in the TPU kernel, and keep h and c themselves in float32. The
// wrapper (ops/cuda_lstm.py) picks the body by dtype and shape alone:
//
// * Tensor-core body (lstm_seq_tc_forward): bf16 with H % 128 == 0 and a
//   W_hh slice of H*H/2 bytes within a block's 227 KB (H <= 640). W_hh stays
//   in shared memory for the whole call, split by columns across a cluster
//   of 16 CTAs, and the recurrent product runs on mma.sync; its design is
//   described above lstm_seq_tc_kernel.
// * Scalar body (lstm_seq_forward): float32, and bf16 shapes the
//   tensor-core body does not take. float32 needs true float32 products
//   (TF32 off), which tensor cores do not give.
//
// Scalar body. One block owns a tile of kTileB batch rows for the whole
// sequence; batch rows are independent, so no block needs another block's
// state. The tile keeps in shared memory:
//   c in float32, for the update;
//   h rounded to cd (stored as float, double-buffered), the left operand of
//   the recurrent product.
// The LSTM update reads c and not the previous h, so the float32 h goes from
// registers straight to `out` and needs no shared copy (B1 keeps one because
// the GRU update reads the previous h). Each thread owns hidden columns j
// and computes the four gate columns j, H+j, 2H+j, 3H+j for all rows of the
// tile with scalar FMAs. The ragged last tile is masked here, so any B >= 1
// is valid.
//
// Tile: 8 rows. At the serving batch B=1024 that is 128 blocks on the 132
// SMs; 16 rows (B1's tile) would give 64 blocks and leave half the SMs idle.
// The price is half as many FMAs for each W_hh element read from L2.
//
// This body streams W_hh from L2 every step (2 MiB at bf16 and H=512,
// against 50 MB of L2): it is bound by FMA issue and L2 reads, far above the
// bound above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace {

constexpr int kTileB = 8;     // batch rows per block
constexpr int kThreads = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// round a float32 value to the compute dtype and back
__device__ __forceinline__ float round_cd(float v, float*) { return v; }
__device__ __forceinline__ float round_cd(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_seq_kernel(const T* __restrict__ xg,        // (T, B, 4H) compute dtype
                const T* __restrict__ whh,       // (H, 4H) compute dtype
                const float* __restrict__ bhh,   // (4H,)
                const float* __restrict__ h0,    // (B, H)
                const float* __restrict__ c0,    // (B, H)
                float* __restrict__ out,         // (T, B, H)
                float* __restrict__ c_last,      // (B, H)
                int steps, int batch, int hidden, int reverse) {
  extern __shared__ float4 smem4[];
  const int tile = kTileB * hidden;
  float* c_s = reinterpret_cast<float*>(smem4);  // [kTileB][H] float32 cell state
  float* h_c = c_s + tile;                        // [2][kTileB][H] h rounded to cd

  const int b0 = blockIdx.x * kTileB;
  const int rows = min(kTileB, batch - b0);
  const int h4 = 4 * hidden;

  // rows past the batch stay 0 in both h buffers and are never stored
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i / hidden;
    const size_t src = (size_t)(b0 + r) * hidden + (i % hidden);
    c_s[i] = r < rows ? c0[src] : 0.0f;
    h_c[i] = r < rows ? round_cd(h0[src], (T*)nullptr) : 0.0f;
    h_c[tile + i] = 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    const float* hc_cur = h_c + (s & 1) * tile;
    float* hc_next = h_c + ((s + 1) & 1) * tile;
    const T* xg_t = xg + (size_t)t * batch * h4;
    float* out_t = out + (size_t)t * batch * hidden;

    for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
      float acc[4][kTileB];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < kTileB; ++r) acc[g][r] = 0.0f;

      for (int k = 0; k < hidden; k += 4) {
        float w[4][4];  // [gate][k + u]
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const T* wrow = whh + (size_t)(k + u) * h4 + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) w[g][u] = to_f32(wrow[g * hidden]);
        }
#pragma unroll
        for (int r = 0; r < kTileB; ++r) {
          // every thread of the warp reads the same address: a broadcast
          const float4 hv = *reinterpret_cast<const float4*>(hc_cur + r * hidden + k);
          const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[g][r] = fmaf(hk[u], w[g][u], acc[g][r]);
        }
      }

      const float bi = bhh[j], bf = bhh[hidden + j];
      const float bg = bhh[2 * hidden + j], bo = bhh[3 * hidden + j];
#pragma unroll
      for (int r = 0; r < kTileB; ++r) {
        if (r < rows) {
          const T* x = xg_t + (size_t)(b0 + r) * h4;
          const float ig = sigmoid_f(to_f32(x[j]) + (acc[0][r] + bi));
          const float fg = sigmoid_f(to_f32(x[hidden + j]) + (acc[1][r] + bf));
          const float gg = tanhf(to_f32(x[2 * hidden + j]) + (acc[2][r] + bg));
          const float og = sigmoid_f(to_f32(x[3 * hidden + j]) + (acc[3][r] + bo));
          // column j of c_s is read and written by this thread only
          const float c_new = fg * c_s[r * hidden + j] + ig * gg;
          const float h_new = og * tanhf(c_new);
          c_s[r * hidden + j] = c_new;
          hc_next[r * hidden + j] = round_cd(h_new, (T*)nullptr);
          out_t[(size_t)(b0 + r) * hidden + j] = h_new;
        }
      }
    }
    // all reads of hc_cur end before the next step overwrites it
    __syncthreads();
  }

  for (int i = threadIdx.x; i < rows * hidden; i += blockDim.x)
    c_last[(size_t)b0 * hidden + i] = c_s[i];
}

template <typename T>
cudaError_t launch(const void* xg, const void* whh, const void* bhh, const void* h0,
                   const void* c0, void* out, void* c_last, int steps, int batch,
                   int hidden, int reverse, cudaStream_t stream) {
  const size_t smem = (size_t)3 * kTileB * hidden * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lstm_seq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kTileB - 1) / kTileB);
  lstm_seq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xg), static_cast<const T*>(whh),
      static_cast<const float*>(bhh), static_cast<const float*>(h0),
      static_cast<const float*>(c0), static_cast<float*>(out),
      static_cast<float*>(c_last), steps, batch, hidden, reverse);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core body (bf16), the design of gru_seq.cu's tensor-core body with
// four gates instead of three.
//
// * W_hh stays on chip for the whole call. A cluster of kCluster = 16 CTAs
//   splits its columns: CTA `rank` owns the U = H/16 hidden units
//   rank*U .. rank*U+U-1, and with them their i, f, g and o columns of
//   W_hh, H x 4U bf16 = 128 KB at H=512, loaded once into shared memory in
//   mma.sync B-fragment order, so that a warp reads each fragment as one
//   conflict-free 256-byte run. 128 KB leaves one CTA per SM.
// * Each cluster owns a contiguous run of rows_per_cluster batch rows for
//   all T steps; the clusters are independent, and the wrapper sizes their
//   number by cudaOccupancyMaxActiveClusters.
// * The product runs on tensor cores: mma.sync m16n8k16 bf16 -> f32 with
//   the accumulators started at b_hh. A warp owns a chunk of 16 batch rows
//   at a time and all 4U columns of its CTA: n-tile 4g+q holds gate q of
//   units 8g..8g+7, so each thread's accumulators hold i, f, g and o of the
//   same (row, unit) positions, and the whole cell update runs in
//   registers.
// * h crosses the cluster through L2, as in gru_seq.cu: each thread writes
//   its new h, rounded to bf16, into the scratch `hs` already in A-fragment
//   order and double-buffered by step parity (store_h); h0 goes into buffer
//   0 before the first barrier. One barrier.cluster.arrive.release /
//   wait.acquire per step orders those writes before the next step's reads
//   and ends a buffer's reads before it is written again.
// * c stays with the thread that owns it. A thread's accumulator positions
//   are the same at every step, so are its c positions; the running c lives
//   in c_last itself, read (c0 at the first step) and written back by that
//   thread alone. That costs no shared memory, which the W_hh slice fills,
//   and no scratch; registers would not do, since a warp carries a number
//   of chunks that depends on the batch. The update reads c, not the
//   previous h, so nothing is read back from out.
// * The gate operands (the bf16 pairs of x_gates for all four gates) and c
//   are loaded before the product, so their latency hides behind it; the
//   gate functions avoid the IEEE division (sigmoid_tc, tanh_tc).
//
// Geometry. At H=512 a thread holds 16 n-tiles' 64 accumulators. 12 warps
// a CTA, A loaded 4 k-steps ahead: 168 registers, no spills, and at B=1024
// (7 clusters of 160 rows, 10 chunks a CTA) every warp carries at most one
// chunk a step. Measured on an H100 (PERF.md, scripts/lstm_tc_probe.py):
// 0.457 ms, against 0.562 with 8 warps (184 registers; two warps carry two
// chunks and set the pace) and 0.500 with 16 (128 registers, spills). At
// H=640 the 80 accumulators need more registers than 12 warps leave, so
// that width takes 8.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kAhead = 4;      // k-steps of A loaded ahead together
constexpr int kMaxGroups = 5;  // 8-unit groups per CTA: H = 128 * groups <= 640

// warps per CTA at `groups` 8-unit groups (H = 128 * groups)
__host__ __device__ constexpr int warps_for(int groups) { return groups <= 4 ? 12 : 8; }

template <int kGroups>
__global__ void __launch_bounds__(warps_for(kGroups) * 32, 1)
lstm_seq_tc_kernel(const __nv_bfloat16* __restrict__ xg,  // (T, B, 4H), 4-byte aligned
                   const __nv_bfloat16* __restrict__ whh, // (H, 4H)
                   const float* __restrict__ bhh,         // (4H,)
                   const float* __restrict__ h0,          // (B, H)
                   const float* __restrict__ c0,          // (B, H)
                   float* __restrict__ out,               // (T, B, H)
                   float* __restrict__ c_last,            // (B, H), the running c
                   uint4* __restrict__ hs,                // [2][chunks][H/16][32]
                   int steps, int batch, int rows_per_cluster, int reverse) {
  constexpr int U = 8 * kGroups;       // hidden units of this CTA
  constexpr int H = kCluster * U;
  constexpr int KS = H / 16;           // k-steps of the product
  constexpr int NT = 4 * kGroups;      // n-tiles: 4g+q = gate q of unit group g
  constexpr int KB = KS / kAhead;
  constexpr int kWarps = warps_for(kGroups);
  constexpr int kThreads = kWarps * 32;
  static_assert(KS % kAhead == 0, "kAhead must divide the k-steps");
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
    const int g = i % kGroups, q = (i / kGroups) % 4, k = i / NT, kk = k & 15;
    const __nv_bfloat16* src = whh + (size_t)k * 4 * H + q * H + rank * U + 8 * g;
    __nv_bfloat16* dst =
        reinterpret_cast<__nv_bfloat16*>(w_s + ((k >> 4) * NT + 4 * g + q) * 32);
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

  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    const uint4* h_cur = hs + (s & 1) * parity;
    uint4* h_next = hs + ((s + 1) & 1) * parity;
    for (int c = warp; c < chunks; c += kWarps) {
      // the cell update's operands first, so that their latency hides
      // behind the product
      uint32_t xw[kGroups][4][2];  // bf16 pairs of x_gates [group][gate][row]
      float cp[kGroups][2][2];     // c of step s-1 [group][row][unit]
      size_t row[2];               // (t, r) as a row of x_gates and out
      size_t cell[2];              // r as a row of c0 and c_last
      bool ok[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row_base + c * kChunk + 8 * hh;
        ok[hh] = r < batch;
        row[hh] = (size_t)t * batch + r;
        cell[hh] = (size_t)r * H + unit0;
        const __nv_bfloat16* x = xg + row[hh] * 4 * H + unit0;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xw[g][q][hh] = ok[hh] ? __ldg(reinterpret_cast<const unsigned int*>(
                                        x + q * H + 8 * g))
                                  : 0u;
          // c0 may lie on a 4-byte boundary only; c_last is the wrapper's own
          // and is read past the non-coherent cache, since this kernel writes it
          float2 cv = make_float2(0.0f, 0.0f);
          if (ok[hh])
            cv = s == 0 ? make_float2(c0[cell[hh] + 8 * g], c0[cell[hh] + 8 * g + 1])
                        : __ldcg(reinterpret_cast<const float2*>(c_last + cell[hh] + 8 * g));
          cp[g][hh][0] = cv.x;
          cp[g][hh][1] = cv.y;
        }
      }

      // hg = h @ W_hh + b_hh, f32 accumulation; A from L2, B from shared
      float acc[NT][4];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float b0 = __ldg(bhh + q * H + unit0 + 8 * g);
          const float b1 = __ldg(bhh + q * H + unit0 + 8 * g + 1);
          acc[4 * g + q][0] = acc[4 * g + q][2] = b0;
          acc[4 * g + q][1] = acc[4 * g + q][3] = b1;
        }
      }
      const uint4* a_src = h_cur + (chunk0 + c) * KS * 32 + lane;
      uint4 a[2][kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) a[0][k] = __ldcg(a_src + k * 32);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        if (kb + 1 < KB) {
#pragma unroll
          for (int k = 0; k < kAhead; ++k)
            a[(kb + 1) & 1][k] = __ldcg(a_src + ((kb + 1) * kAhead + k) * 32);
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          const uint2* b = w_s + (kb * kAhead + k) * NT * 32 + lane;
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a[kb & 1][k], b[j * 32]);
        }
      }

      // i, f, g, o, the new c and h, in registers
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float hn[2][2], cn[2][2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * hh + e;
            const float ig = sigmoid_tc(bf16_at(xw[g][0][hh], e) + acc[4 * g][i]);
            const float fg = sigmoid_tc(bf16_at(xw[g][1][hh], e) + acc[4 * g + 1][i]);
            const float gg = tanh_tc(bf16_at(xw[g][2][hh], e) + acc[4 * g + 2][i]);
            const float og = sigmoid_tc(bf16_at(xw[g][3][hh], e) + acc[4 * g + 3][i]);
            cn[hh][e] = fg * cp[g][hh][e] + ig * gg;
            hn[hh][e] = og * tanh_tc(cn[hh][e]);
          }
          if (ok[hh]) {
            *reinterpret_cast<float2*>(out + row[hh] * H + unit0 + 8 * g) =
                make_float2(hn[hh][0], hn[hh][1]);
            __stcg(reinterpret_cast<float2*>(c_last + cell[hh] + 8 * g),
                   make_float2(cn[hh][0], cn[hh][1]));
          }
        }
        store_h(h_next, chunk0 + c, KS, g0 + g, lane, hn[0], hn[1]);
      }
    }
    // step s's h is written everywhere before step s+1 reads it, and step
    // s's reads of h_cur end before step s+1 overwrites it
    if (s + 1 < steps) cluster_sync();
  }
}

// the W_hh slice: H x 4U bf16 = H*H/2 bytes
constexpr size_t smem_bytes(int groups) {
  return (size_t)(8 * groups) * (4 * groups) * 32 * sizeof(uint2);
}

template <int kGroups>
cudaError_t prepare() {
  cudaError_t err = cudaFuncSetAttribute(lstm_seq_tc_kernel<kGroups>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(kGroups));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(lstm_seq_tc_kernel<kGroups>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <int kGroups>
cudaError_t max_clusters(int* n) {
  cudaError_t err = prepare<kGroups>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(1, warps_for(kGroups) * 32, smem_bytes(kGroups), nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(n, lstm_seq_tc_kernel<kGroups>, &cfg);
}

template <int kGroups>
cudaError_t launch(const void* xg, const void* whh, const void* bhh, const void* h0,
                   const void* c0, void* out, void* c_last, void* hs, int steps,
                   int batch, int clusters, int rows_per_cluster, int reverse,
                   cudaStream_t stream) {
  cudaError_t err = prepare<kGroups>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(clusters, warps_for(kGroups) * 32, smem_bytes(kGroups), stream, &attr);
  err = cudaLaunchKernelEx(&cfg, lstm_seq_tc_kernel<kGroups>,
                           static_cast<const __nv_bfloat16*>(xg),
                           static_cast<const __nv_bfloat16*>(whh),
                           static_cast<const float*>(bhh), static_cast<const float*>(h0),
                           static_cast<const float*>(c0), static_cast<float*>(out),
                           static_cast<float*>(c_last), static_cast<uint4*>(hs), steps,
                           batch, rows_per_cluster, reverse);
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
    case 5: return max_clusters<5>(n);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_any(const void* x, const void* w, const void* b, const void* h0,
                       const void* c0, void* out, void* c_last, void* hs, int steps,
                       int batch, int hidden, int clusters, int rows, int reverse,
                       cudaStream_t s) {
  switch (groups_for(hidden)) {
    case 1: return launch<1>(x, w, b, h0, c0, out, c_last, hs, steps, batch, clusters, rows, reverse, s);
    case 2: return launch<2>(x, w, b, h0, c0, out, c_last, hs, steps, batch, clusters, rows, reverse, s);
    case 3: return launch<3>(x, w, b, h0, c0, out, c_last, hs, steps, batch, clusters, rows, reverse, s);
    case 4: return launch<4>(x, w, b, h0, c0, out, c_last, hs, steps, batch, clusters, rows, reverse, s);
    case 5: return launch<5>(x, w, b, h0, c0, out, c_last, hs, steps, batch, clusters, rows, reverse, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// x_gates (T, B, 4H) and w_hh (H, 4H) in bf16 when is_bf16 != 0, else
// float32; b_hh (4H,), h0, c0, c_last (B, H) and out (T, B, H) float32; all
// contiguous on the card. reverse != 0 walks t from T-1 down to 0.
// Launches on `stream`, does not synchronise, allocates nothing.
// Returns the cudaError_t of the launch (0 on success).
int lstm_seq_forward(const void* x_gates, const void* w_hh, const void* b_hh,
                     const void* h0, const void* c0, void* out, void* c_last,
                     int steps, int batch, int hidden, int is_bf16, int reverse,
                     void* stream) {
  if (steps < 1 || batch < 1 || hidden < 4 || hidden % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch<__nv_bfloat16>(x_gates, w_hh, b_hh, h0, c0, out, c_last,
                                           steps, batch, hidden, reverse, s)
                   : launch<float>(x_gates, w_hh, b_hh, h0, c0, out, c_last,
                                   steps, batch, hidden, reverse, s));
}

// Clusters of the tensor-core body that the current card holds at once, at
// this hidden size; 0 if none, a negated cudaError_t if the query failed.
int lstm_seq_tc_clusters(int hidden) {
  int n = 0;
  const cudaError_t err = tc::max_clusters_any(hidden, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// The contract of lstm_seq_forward in bf16 through the tensor-core body,
// with H % 128 == 0 and H <= 640, x_gates 4-byte aligned. hs is a scratch
// of 2 * clusters * rows_per_cluster * H bf16 values; `clusters` clusters of
// 16 CTAs each own rows_per_cluster (a multiple of 16) batch rows, and
// clusters * rows_per_cluster >= batch. c_last also holds the running c, so
// it must not overlap c0. Launches on `stream`, does not synchronise,
// allocates nothing. Returns the cudaError_t of the launch.
int lstm_seq_tc_forward(const void* x_gates, const void* w_hh, const void* b_hh,
                        const void* h0, const void* c0, void* out, void* c_last,
                        void* hs, int steps, int batch, int hidden, int clusters,
                        int rows_per_cluster, int reverse, void* stream) {
  if (steps < 1 || batch < 1 || clusters < 1 || rows_per_cluster < tc::kChunk ||
      rows_per_cluster % tc::kChunk != 0 ||
      (long long)clusters * rows_per_cluster < batch || tc::groups_for(hidden) == 0 ||
      reinterpret_cast<uintptr_t>(x_gates) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)tc::launch_any(x_gates, w_hh, b_hh, h0, c0, out, c_last, hs, steps, batch,
                             hidden, clusters, rows_per_cluster, reverse,
                             static_cast<cudaStream_t>(stream));
}

const char* lstm_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
