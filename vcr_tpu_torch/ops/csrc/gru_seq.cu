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
// Design. The TPU kernel carries h in scratch memory from one sequential grid
// step to the next; CUDA blocks run in no order, so here the time loop runs
// inside each block instead. One block owns a tile of kTileB batch rows for
// the whole sequence. Batch rows are independent, so no block needs another
// block's h. The tile keeps h in shared memory twice: float32 for the gate
// update, and rounded to cd (stored as float, double-buffered) as the left
// operand of the recurrent product, which is what h.astype(compute_dtype)
// does in the TPU kernel. Each thread owns hidden columns j and computes the
// three gate columns j, H+j, 2H+j for all rows of the tile with scalar FMAs.
// The ragged last tile is masked here, so any B >= 1 is valid.
//
// This first design streams W_hh from L2 every step (1.5 MiB at bf16 and
// H=512, against 50 MB of L2) and uses neither wgmma nor TMA: it is bound by
// FMA issue and L2 reads, far above the bound above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

const char* gru_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
