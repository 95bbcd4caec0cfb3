// GRU recurrence with a hand-built copy pipeline (kernel B4), for Hopper
// (sm_90a).
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
// and each output goes out from a slot whose copy is awaited two steps
// later, before the slot is written again. Here the same pipeline is built
// from Hopper's bulk copies (TMA without a tensor map):
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
// A tile's rows of one step are one contiguous run of rows*3H (in) and
// rows*H (out) elements in the time-major layout, so each copy is a single
// 1-D bulk copy, the ragged last tile included. Bulk copies need 16-byte
// addresses and sizes: H % 8 == 0.
//
// The recurrent product and gate math are those of B1's scalar body, in its
// FMA order and on the same rounded h (float, double-buffered): B4 agrees
// with B1 bit for bit in float32, where B1 runs that body. In bf16 B1 runs
// its tensor-core body, which sums in another order, so there the two agree
// only within the kernels' tolerance. B1's scalar body keeps a separate
// float32 h; here the out slot of step t-1 holds exactly that h while step t
// reads it (its store only reads it too), so the block needs no third copy,
// and a 16-row tile fits in the 227 KB a block may have at H=512 in bf16:
// 2 x_gates slots 96 KB, 2 out slots 64 KB, 2 rounded h 64 KB. The tile is
// the largest of 16, 8, 4, 2, 1 rows that fits: 16 in bf16 and 8 in float32
// at H=512. W_hh streams from L2 every step, as in B1's scalar body.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

const char* gru_seq_dma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
