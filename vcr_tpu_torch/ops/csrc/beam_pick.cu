// The beam's word pick, one launch a decode step, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package picks the words with
// jax.nn.log_softmax, a where and two lax.top_k calls (vcr_tpu/decode.py,
// beam_search), which XLA fuses; lax.top_k has no Pallas counterpart. On the
// card the same body in plain PyTorch (ops/beam_pick.py, beam_pick_plain) ran
// a log-softmax, two elementwise passes and a full stable sort of every
// (B*K, V) float32 row each step. This kernel reads each live row once.
//
// For B items of K beams, with logits (B*K, V) float32, scores (B*K,) and
// finished (B*K,) it computes, as beam_pick_plain does:
//   logp = (x - max) - log(sum exp(x - max))        per row, in float32;
//   cont = logp, or for a finished row 0 at eos_id and NEG_INF elsewhere
//          (its logits are never read);
//   stage 1: the top K of score + cont in each row;
//   stage 2: the top K of each item's K*K survivors (position beam*K + rank);
//   top_scores (B, K), word_idx (B, K) int32 (the stage-1 word of each pick),
//   flat_src (B*K,) int64 = item*K + beam.
// Both stages order by value descending, then index ascending: lax.top_k's
// order, which a stable descending sort also gives. The order is exact on the
// float32 values the kernel forms, rounded ties included (the NEG_INF rows of
// step 0 and the finished rows tie on every word and are decided by index).
//
// Bound: each live row's logits read once, 4*B*K*V bytes; at the beam-5
// serving cell (B=512, K=5, V=9,088) 93.06 MB a step, 27.8 us at the H100's
// 3.35 TB/s. The outputs are a few KB.
//
// Design. One block of kThreads threads per row, so that the card's block
// scheduler keeps four blocks on every SM at different points of their rows
// (a block per item, walking its K rows, held more registers and spilled).
// A row is cut into tiles of kThreads*4*NV columns held in registers, NV
// float4 loads a thread: up to 12,288 columns (NV=12) a row is one tile and
// is read once; a wider row is read again for the sum and for the pick
// (three reads, mostly from L2). Per row: the block's max and sum of exp,
// then each value's order key (an unsigned of the float's order) and each
// thread's best two; each warp takes its top K by K rounds of a shuffle
// arg-max (a thread that wins moves to its second best, and rescans only
// when it wins twice in a row), and warp 0 merges the warps' lists (with
// the running list of earlier tiles) the same way from shared memory. Stage
// 2 runs in the same launch: each row's block writes its K picks to a
// scratch buffer and counts itself done on an atomic counter of its item,
// zeroed by a memset just before the launch; the item's last block (the one
// that counts K) reads the K*K picks back and takes their top K. A cluster
// of K blocks merging through distributed shared memory would cap K at the
// cluster size; K <= kMaxK (32) here, so every list fits a warp's lanes.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 32;
constexpr int kMaxNV = 12;            // float4 loads a thread a tile
constexpr float kNegInf = -1e9f;      // decode.NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// a before b: larger value, or equal value and lower index
__device__ __forceinline__ bool better(float av, int ak, float bv, int bk) {
  return av > bv || (av == bv && ak < bk);
}

// every lane ends with the warp's best (v, k)
__device__ __forceinline__ void warp_best(float& v, int& k) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int ok = __shfl_xor_sync(kFull, k, off);
    if (better(ov, ok, v, k)) {
      v = ov;
      k = ok;
    }
  }
}

// every lane ends with the warp's largest key, the lower column among equals
__device__ __forceinline__ void warp_best_key(unsigned& key, int& col) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const unsigned ok = __shfl_xor_sync(kFull, key, off);
    const int oc = __shfl_xor_sync(kFull, col, off);
    if (ok > key || (ok == key && oc < col)) {
      key = ok;
      col = oc;
    }
  }
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

// item j of a thread lies slot_offset(j) columns after the thread's first
__device__ __forceinline__ constexpr int slot_offset(int j) {
  return 4 * kThreads * (j >> 2) + (j & 3);
}

// column of this thread's item j in the tile starting at column `base`
__device__ __forceinline__ int column(int base, int j) {
  return base + 4 * threadIdx.x + slot_offset(j);
}

// the tile's logits, as the bits of each float; -inf past the row's end,
// which moves neither its max nor its sum of exp
template <int NV>
__device__ __forceinline__ void load_tile(const float* __restrict__ row, int base, int vocab,
                                          bool vec, unsigned (&x)[4 * NV]) {
  constexpr unsigned kMinusInf = 0xff800000u;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int col = column(base, 4 * q);
    if (vec) {
      // vocab % 4 == 0: a float4 that starts inside the row ends inside it
      uint4 f = make_uint4(kMinusInf, kMinusInf, kMinusInf, kMinusInf);
      if (col < vocab) f = __ldg(reinterpret_cast<const uint4*>(row + col));
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[4 * q + c] = col + c < vocab ? __float_as_uint(__ldg(row + col + c)) : kMinusInf;
    }
  }
}

// A float as an unsigned key of the same order; 0, below every number, marks
// an item outside the row. Equal keys are equal floats for all but -0 and
// +0, and a value here is never -0: the score is made +0 if it is 0, and a
// sum is -0 only where both terms are.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// (b1, j1), (b2, j2): a thread's two best keys so far and their slots, the
// lower slot first among equals, scanning slots upwards; a key of 0 is none
__device__ __forceinline__ void keep_two(unsigned v, int j, unsigned& b1, int& j1,
                                         unsigned& b2, int& j2) {
  if (v > b1) {
    b2 = b1;
    j2 = j1;
    b1 = v;
    j1 = j;
  } else if (v > b2) {
    b2 = v;
    j2 = j;
  }
}

// A thread's two best items after (lk, lj), the last it gave up: a thread
// gives its items up in its own order, so those after it are the ones left.
template <int NV>
__device__ __forceinline__ void best_two_after(const unsigned (&x)[4 * NV], unsigned lk,
                                               int lj, unsigned& b1, int& j1, unsigned& b2,
                                               int& j2) {
  b1 = b2 = 0u;
  j1 = j2 = 0;
#pragma unroll
  for (int j = 0; j < 4 * NV; ++j)
    if (x[j] < lk || (x[j] == lk && j > lj)) keep_two(x[j], j, b1, j1, b2, j2);
}

// Warp-wide top k of n shared-memory candidates (v[i], key[i], or the slot i
// where key is null), keys unique: lane j < k ends holding the j-th best.
__device__ __forceinline__ void warp_top_k(const float* v, const int* key, int n, int k,
                                           float& out_v, int& out_k) {
  const int lane = threadIdx.x & 31;
  unsigned taken = 0u;  // n <= 32 * 32: one bit per slot of this lane
  float bv;
  int bk, bt;
  auto rescan = [&]() {
    bv = -INFINITY;
    bk = INT_MAX;
    bt = -1;
    for (int t = 0, i = lane; i < n; ++t, i += 32) {
      const int ck = key ? key[i] : i;
      if (!((taken >> t) & 1u) && better(v[i], ck, bv, bk)) {
        bv = v[i];
        bk = ck;
        bt = t;
      }
    }
  };
  rescan();
  for (int j = 0; j < k; ++j) {
    float wv = bv;
    int wk = bk;
    warp_best(wv, wk);
    if (lane == j) {
      out_v = wv;
      out_k = wk;
    }
    if (bt >= 0 && bk == wk) {
      taken |= 1u << bt;
      rescan();
    }
  }
}

// at most 64 registers a thread up to 9 loads (V <= 9,216): four blocks an SM
template <int NV>
__global__ void __launch_bounds__(kThreads, NV <= 9 ? 4 : 2)
beam_pick_kernel(const float* __restrict__ logits, const float* __restrict__ scores,
                 const bool* __restrict__ finished, int vocab, int k, int eos_id, int vec,
                 float* __restrict__ picks_v, int* __restrict__ picks_w,
                 unsigned* __restrict__ done, float* __restrict__ top_scores,
                 int* __restrict__ word_idx, long long* __restrict__ flat_src) {
  constexpr int kTile = kThreads * 4 * NV;
  __shared__ float red[kWarps];
  // the warps' lists of a tile (k entries each), then the row's running
  // list; two buffers, by tile parity, so that the other warps go on to the
  // next tile while warp 0 merges this one
  __shared__ float list_v[2][(kWarps + 1) * kMaxK];
  __shared__ int list_k[2][(kWarps + 1) * kMaxK];
  __shared__ float run_v[kMaxK];  // the row's running top k
  __shared__ int run_k[kMaxK];
  __shared__ float s2_v[kMaxK * kMaxK];  // stage 2: the item's K*K picks

  const int row = blockIdx.x;
  const int item = row / k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (vocab + kTile - 1) / kTile;
  const float* src = logits + static_cast<int64_t>(row) * vocab;
  const float score = scores[row] == 0.0f ? 0.0f : scores[row];
  const bool fin = finished[row];
  unsigned x[4 * NV];  // a tile's logits, then the order keys of its values

  float mx = 0.0f, lse = 0.0f;
  if (!fin) {
    float m = -INFINITY;
    for (int t = 0; t < tiles; ++t) {
      load_tile<NV>(src, t * kTile, vocab, vec, x);
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) m = fmaxf(m, __uint_as_float(x[j]));
    }
    mx = block_max(m, red);
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      if (tiles > 1) load_tile<NV>(src, t * kTile, vocab, vec, x);
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) s += expf(__uint_as_float(x[j]) - mx);
    }
    lse = logf(block_sum(s, red));
  }
  for (int t = 0; t < tiles; ++t) {
    const int base = t * kTile;
    if (!fin && tiles > 1) load_tile<NV>(src, base, vocab, vec, x);
    // each value with the plain version's roundings, (x - max) - lse, then
    // score + that, as its order key; the thread's best two
    unsigned b1 = 0u, b2 = 0u;
    int j1 = 0, j2 = 0;
    const int left = vocab - column(base, 0);  // item j is in the row iff its offset < left
    if (fin) {
      const unsigned at_eos = order_key(__fadd_rn(score, 0.0f));
      const unsigned elsewhere = order_key(__fadd_rn(score, kNegInf));
      const int to_eos = eos_id - column(base, 0);
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) {
        x[j] = slot_offset(j) < left ? (slot_offset(j) == to_eos ? at_eos : elsewhere) : 0u;
        keep_two(x[j], j, b1, j1, b2, j2);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) {
        const float cont = __fsub_rn(__fsub_rn(__uint_as_float(x[j]), mx), lse);
        x[j] = slot_offset(j) < left ? order_key(__fadd_rn(score, cont)) : 0u;
        keep_two(x[j], j, b1, j1, b2, j2);
      }
    }
    // each warp's top k of its registers, in order, into its list: k rounds
    // of the lanes' best keys, the lower column among equals
    float* lv = list_v[t & 1];
    int* lk = list_k[t & 1];
    bool has_second = true;
    for (int j = 0; j < k; ++j) {
      unsigned wk = b1;
      int wc = b1 ? column(base, j1) : INT_MAX;
      warp_best_key(wk, wc);
      if (lane == 0) {
        lv[warp * k + j] = wk ? key_value(wk) : -INFINITY;
        lk[warp * k + j] = wc;
      }
      if (b1 && column(base, j1) == wc) {
        if (has_second) {
          b1 = b2;
          j1 = j2;
        } else {
          best_two_after<NV>(x, b1, j1, b1, j1, b2, j2);
        }
        has_second = !has_second;
      }
    }
    __syncthreads();
    if (warp == 0) {
      // merge the warps' lists with the running list of the earlier tiles;
      // the block's next barrier waits for it, and the tile after next
      // writes these buffers again only after that barrier
      int n = kWarps * k;
      if (t > 0) {
        if (lane < k) {
          lv[n + lane] = run_v[lane];
          lk[n + lane] = run_k[lane];
        }
        n += k;
        __syncwarp();
      }
      float v;
      int key;
      warp_top_k(lv, lk, n, k, v, key);
      __syncwarp();
      if (lane < k) {
        run_v[lane] = v;
        run_k[lane] = key;
      }
      __syncwarp();
    }
  }
  if (warp != 0) return;

  // stage 2: the row's picks to the scratch, then the item's last row's
  // block takes the top k of the item's K*K
  if (lane < k) {
    picks_v[static_cast<int64_t>(row) * k + lane] = run_v[lane];
    picks_w[static_cast<int64_t>(row) * k + lane] = run_k[lane];
  }
  __threadfence();
  __syncwarp();
  unsigned before = 0u;
  if (lane == 0) before = atomicAdd(done + item, 1u);
  if (__shfl_sync(kFull, before, 0) != static_cast<unsigned>(k - 1)) return;
  __threadfence();
  const int64_t first = static_cast<int64_t>(item) * k * k;
  for (int i = lane; i < k * k; i += 32) s2_v[i] = __ldcg(picks_v + first + i);
  __syncwarp();
  float v;
  int p;
  warp_top_k(s2_v, nullptr, k * k, k, v, p);
  if (p >= k * k) p = 0;  // only where no candidate compares (NaN rows)
  if (lane < k) {
    const int64_t out = static_cast<int64_t>(item) * k + lane;
    top_scores[out] = v;
    word_idx[out] = __ldcg(picks_w + first + p);
    flat_src[out] = static_cast<int64_t>(item) * k + p / k;
  }
}

// scratch: each row's k pick values, then their words, then the items'
// counters of rows done
template <int NV>
cudaError_t launch(const void* logits, const void* scores, const void* finished,
                   void* scratch, void* top_scores, void* word_idx, void* flat_src,
                   int items, int k, int vocab, int eos_id, int vec, cudaStream_t stream) {
  const int64_t picks = static_cast<int64_t>(items) * k * k;
  float* picks_v = static_cast<float*>(scratch);
  int* picks_w = reinterpret_cast<int*>(picks_v + picks);
  unsigned* done = reinterpret_cast<unsigned*>(picks_w + picks);
  cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned) * items, stream);
  if (err != cudaSuccess) return err;
  beam_pick_kernel<NV><<<items * k, kThreads, 0, stream>>>(
      static_cast<const float*>(logits), static_cast<const float*>(scores),
      static_cast<const bool*>(finished), vocab, k, eos_id, vec, picks_v, picks_w, done,
      static_cast<float*>(top_scores), static_cast<int*>(word_idx),
      static_cast<long long*>(flat_src));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 4-byte words of scratch a launch of `items` items of k beams needs
long long beam_pick_scratch_words(int items, int k) {
  return 2LL * items * k * k + items;
}

// float4 loads a thread a tile for a row of `vocab` columns (1..12): one
// tile up to 12,288 columns
int beam_pick_loads(int vocab) {
  const int nv = (vocab + 4 * kThreads - 1) / (4 * kThreads);
  return nv < 1 ? 1 : (nv > kMaxNV ? kMaxNV : nv);
}

// The word pick of `items` items of k beams: logits (items*k, vocab) float32,
// scores (items*k,) float32, finished (items*k,) bool, all contiguous on the
// card; top_scores (items, k) float32, word_idx (items, k) int32, flat_src
// (items*k,) int64, allocated by the caller, with `scratch` of
// beam_pick_scratch_words(items, k) 4-byte words, any contents. 1 <= k <= 32,
// k <= vocab, 0 <= eos_id < vocab. Sets scratch's counters to 0 and
// launches, both on `stream`; does not synchronise, allocates nothing.
// Returns the cudaError_t of the memset or of the launch (0 on success).
int beam_pick_forward(const void* logits, const void* scores, const void* finished,
                      void* scratch, void* top_scores, void* word_idx, void* flat_src,
                      int items, int k, int vocab, int eos_id, void* stream) {
  if (items < 1 || k < 1 || k > kMaxK || vocab < k || eos_id < 0 || eos_id >= vocab)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = vocab % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VCR_PICK(NV)                                                                     \
  case NV:                                                                               \
    return static_cast<int>(launch<NV>(logits, scores, finished, scratch, top_scores,   \
                                       word_idx, flat_src, items, k, vocab, eos_id, vec, \
                                       s))
  switch (beam_pick_loads(vocab)) {
    VCR_PICK(1);
    VCR_PICK(2);
    VCR_PICK(3);
    VCR_PICK(4);
    VCR_PICK(5);
    VCR_PICK(6);
    VCR_PICK(7);
    VCR_PICK(8);
    VCR_PICK(9);
    VCR_PICK(10);
    VCR_PICK(11);
    VCR_PICK(12);
  }
#undef VCR_PICK
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* beam_pick_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
