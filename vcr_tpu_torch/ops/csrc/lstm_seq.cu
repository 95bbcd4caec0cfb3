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
// Design. The TPU kernel carries (h, c) in scratch memory from one sequential
// grid step to the next and gets the reverse direction from its index maps;
// CUDA blocks run in no order, so here the time loop runs inside each block,
// and a flag picks the direction of the walk. One block owns a tile of
// kTileB batch rows for the whole sequence; batch rows are independent, so
// no block needs another block's state. The tile keeps in shared memory:
//   c in float32, for the update;
//   h rounded to cd (stored as float, double-buffered), the left operand of
//   the recurrent product, which is what h.astype(compute_dtype) does in the
//   TPU kernel.
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
// This first design streams W_hh from L2 every step (2 MiB at bf16 and
// H=512, against 50 MB of L2) and uses neither wgmma nor TMA: it is bound by
// FMA issue and L2 reads, far above the bound above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

const char* lstm_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
