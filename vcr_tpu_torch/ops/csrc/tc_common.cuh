// Device helpers and the cluster launch shared by the tensor-core bodies of
// gru_seq.cu (kernels B1 and B3) and lstm_seq.cu (kernel B2).
//
// Both bodies split W_hh by columns over a cluster of kCluster CTAs, run
// the recurrent product on mma.sync m16n8k16 (bf16 -> f32) in chunks of
// kChunk batch rows per warp, and exchange h between steps through an L2
// scratch already in A-fragment order (store_h), behind one cluster barrier
// (cluster_sync) per step. Everything here is inlined into each body, so
// including this header changes no other kernel's machine code.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

constexpr int kCluster = 16;  // CTAs per cluster
constexpr int kChunk = 16;    // batch rows per warp tile (mma M)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, const uint2& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// all threads of the cluster; global and shared writes before it are seen
// by all threads of the cluster after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The gate functions without an IEEE division: its slow-path branch splits
// the gate update into one basic block per value and serialises them. expf
// stays accurate; the reciprocal (__fdividef) is within 2 ulp.
__device__ __forceinline__ float sigmoid_tc(float x) {
  return __fdividef(1.0f, 1.0f + expf(-x));
}
__device__ __forceinline__ float tanh_tc(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + expf(2.0f * x));
}

// element e (0: low half, 1: high half) of a bf16 pair, exactly
__device__ __forceinline__ float bf16_at(uint32_t pair, int e) {
  return __uint_as_float(e ? pair & 0xffff0000u : pair << 16);
}

// The rounded h of rows (gq, gq+8) of chunk `chunk`, units u..u+1 (u even,
// `group` = u's 8-unit group), into A-fragment order: k-step group/2,
// registers {a0, a1} for an even group, {a2, a3} for an odd one.
__device__ __forceinline__ void store_h(uint4* buf, size_t chunk, int ksteps, int group,
                                        int lane, const float (&lo)[2],
                                        const float (&hi)[2]) {
  uint2* p = reinterpret_cast<uint2*>(buf + (chunk * ksteps + (group >> 1)) * 32 + lane)
             + (group & 1);
  __stcg(p, make_uint2(pack_bf16(lo[0], lo[1]), pack_bf16(hi[0], hi[1])));
}

// cluster launch configuration of `clusters` clusters of kCluster CTAs of
// `threads` threads; `attr` must outlive the launch call
inline cudaLaunchConfig_t config(int clusters, int threads, size_t smem,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace tc
}  // namespace
