"""Where the time of the tensor-core GRU body goes, and what wgmma would give.

    python scripts/gru_tc_probe.py [--batches 2048 1024] [--hidden 512]

Builds six copies of ``vcr_tpu_torch/ops/csrc/gru_seq.cu`` with the flags
of ``ops/_build.py``, all at once, into a temporary directory:

* ``mma_sync`` -- the source as it is;
* ``one_per_sm`` -- the same with launch bounds that leave one CTA per SM;
* ``ieee_gates`` -- the same with the gate functions written with IEEE
  divisions and tanhf, as in the scalar body;
* ``timers``   -- the source with clock64() timers around each phase of a
  step (the product, the gate update, the cluster barrier), read back for
  warp 0 and warp 4 of the first CTA;
* ``wgmma``    -- the product rewritten for warpgroups: each group of four
  warps owns 64 batch rows and issues one wgmma.mma_async m64nNk16 per
  k-step (N = 3H/16, A from registers in the same fragment order as
  mma.sync's, B by a matrix descriptor over W_hh stored in the canonical
  K-major layout without swizzle: 8x8 core matrices, 128 bytes apart along
  K and 256 along N), three k-batches of A in flight, rows per cluster a
  multiple of 64;
* ``wgmma_timers`` -- the wgmma copy with the timers.

Each copy's B1 (time-major) and B3 are checked against the plain version at
a few shapes, then timed in turns at the given batches (T=30, bf16), with
the launch geometry of ``cuda_gru.tc_plan``. Prints JSON lines. Needs a card;
the copies are experiments and never reach the port.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vcr_tpu_torch.ops import _build, cuda_gru  # noqa: E402

BF16 = torch.bfloat16


def _patch(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"gru_seq.cu changed; anchor not found once: {old[:60]!r}")
    return text.replace(old, new)


def with_timers(src: str) -> str:
    """Phase timers for threads 0 and 128 of block 0, summed over steps."""
    s = _patch(src, "namespace {\n", "__device__ long long g_phase[16];\nnamespace {\n")
    s = _patch(s, "  for (int t = 0; t < steps; ++t) {\n    const uint4* h_cur",
               "  long long p_prod = 0, p_step = 0, p_bar = 0, p_gate = 0;\n"
               "  for (int t = 0; t < steps; ++t) {\n    long long s0 = clock64();\n"
               "    const uint4* h_cur")
    s = _patch(s, "      // the gate update's operands first",
               "      long long c0 = clock64();\n      // the gate update's operands first")
    s = _patch(s, "      // r, z, n and the new h, in registers\n",
               "      long long c1 = clock64();\n      p_prod += c1 - c0;\n"
               "      // r, z, n and the new h, in registers\n")
    s = _patch(s, "        store_h(h_next, chunk0 + c, KS, g0 + g, lane, hn[0], hn[1]);\n      }\n",
               "        store_h(h_next, chunk0 + c, KS, g0 + g, lane, hn[0], hn[1]);\n      }\n"
               "      p_gate += clock64() - c1;\n")
    s = _patch(s, "    if (t + 1 < steps) cluster_sync();\n  }\n}",
               "    long long s1 = clock64();\n    p_step += s1 - s0;\n"
               "    if (t + 1 < steps) cluster_sync();\n    p_bar += clock64() - s1;\n  }\n"
               "  if (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == 128)) {\n"
               "    long long* p = g_phase + (threadIdx.x ? 8 : 0);\n"
               "    p[0] = p_prod; p[1] = p_gate; p[2] = p_step; p[3] = p_bar;\n  }\n}")
    return s + ('\nextern "C" int gru_seq_phase_clocks(long long* out) {\n'
                "  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n")


def _wgmma_fn(n: int) -> str:
    nd = n // 2
    regs = ",".join(f"%{i}" for i in range(nd))
    a = ",".join(f"%{nd + i}" for i in range(4))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(nd))
    return (f"__device__ __forceinline__ void wgmma_n{n}(float* d, const uint4& a, "
            f"uint64_t desc) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 5}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
            f'      "{{{regs}}}, {{{a}}}, %{nd + 4}, p, 1, 1, 0;\\n}}"\n'
            f"      : {outs}\n"
            f'      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(desc), "r"(1));\n}}\n')


def with_wgmma(src: str) -> str:
    helpers = "".join(_wgmma_fn(24 * g) for g in range(1, 7)) + """
template <int G>
__device__ __forceinline__ void wgmma_tile(float* d, const uint4& a, uint64_t desc) {
  if constexpr (G == 1) wgmma_n24(d, a, desc);
  else if constexpr (G == 2) wgmma_n48(d, a, desc);
  else if constexpr (G == 3) wgmma_n72(d, a, desc);
  else if constexpr (G == 4) wgmma_n96(d, a, desc);
  else if constexpr (G == 5) wgmma_n120(d, a, desc);
  else wgmma_n144(d, a, desc);
}

// K-major, no swizzle: core matrices 128 bytes apart along K, 256 along N
__device__ __forceinline__ uint64_t wg_desc(const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

"""
    anchor = "// kTimeMajor: x_gates (T, B, 3H) and out (T, B, H); else (B, T, 3H), (B, T, H)\n"
    s = _patch(src, anchor, helpers + anchor)
    # W_hh slice in the canonical layout, then made visible to the async proxy
    s = _patch(s, """    __nv_bfloat16* dst =
        reinterpret_cast<__nv_bfloat16*>(w_s + ((k >> 4) * NT + 3 * g + q) * 32);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      dst[(4 * n + ((kk & 7) >> 1)) * 4 + (kk >> 3) * 2 + (kk & 1)] = src[n];
  }""", """    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(w_s) +
        (((k >> 4) * NT + 3 * g + q) * 2 + (kk >> 3)) * 64 + (kk & 7);
#pragma unroll
    for (int n = 0; n < 8; ++n) dst[n * 8] = src[n];
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");""")
    # a warpgroup owns four consecutive chunks: 64 rows
    s = _patch(s, """    for (int c = warp; c < chunks; c += kWarps) {
      // the gate update's operands first""", """    for (int sc = warp >> 2; sc < chunks / 4; sc += kWarps / 4) {
      const int c = sc * 4 + (warp & 3);
      // the gate update's operands first""")
    s = _patch(s, """      uint4 a[2][kAhead];
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
""", """      const __nv_bfloat16* w_b = reinterpret_cast<const __nv_bfloat16*>(w_s);
      uint4 a[3][kAhead];
#pragma unroll
      for (int p = 0; p < 2 && p < KB; ++p) {
#pragma unroll
        for (int s = 0; s < kAhead; ++s) a[p][s] = __ldcg(a_src + (p * kAhead + s) * 32);
      }
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        wg_fence();
#pragma unroll
        for (int s = 0; s < kAhead; ++s)
          wgmma_tile<kGroups>(&acc[0][0], a[kb % 3][s],
                              wg_desc(w_b + (kb * kAhead + s) * NT * 2 * 64));
        wg_commit();
        if (kb + 2 < KB) {
          wg_wait<1>();
#pragma unroll
          for (int s = 0; s < kAhead; ++s)
            a[(kb + 2) % 3][s] = __ldcg(a_src + ((kb + 2) * kAhead + s) * 32);
        }
      }
      wg_wait<0>();
""")
    return _patch(s, "__launch_bounds__(kThreads, kGroups <= 4 ? 2 : 1)",
                  "__launch_bounds__(kThreads, 1)")


def one_per_sm(src: str) -> str:
    return _patch(src, "__launch_bounds__(kThreads, kGroups <= 4 ? 2 : 1)",
                  "__launch_bounds__(kThreads, 1)")


def ieee_gates(src: str) -> str:
    s = _patch(src, "const float rg = sigmoid_tc(", "const float rg = sigmoid_f(")
    s = _patch(s, "const float zg = sigmoid_tc(", "const float zg = sigmoid_f(")
    return _patch(s, "const float ng = tanh_tc(", "const float ng = tanhf(")


def build(name: str, text: str, out_dir: str) -> ctypes.CDLL:
    src = Path(out_dir) / f"{name}.cu"
    src.write_text(text)
    lib = Path(out_dir) / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    cdll = ctypes.CDLL(str(lib))
    cdll.gru_seq_tc_forward.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
    cdll.gru_seq_tc_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
    return cdll


def run(lib, rows_multiple, x_gates, w_hh, b_hh, h0, time_major=True):
    t, b = x_gates.shape[:2] if time_major else x_gates.shape[1::-1]
    hidden = w_hh.shape[0]
    most = lib.gru_seq_tc_clusters(hidden, int(time_major))
    _, _, rows, _ = cuda_gru.tc_plan(b, hidden, BF16, most)
    rows = -(-rows // rows_multiple) * rows_multiple
    clusters = -(-b // rows)
    out = torch.empty((t, b, hidden) if time_major else (b, t, hidden), device="cuda")
    hs = torch.empty((2, clusters * rows, hidden), dtype=BF16, device="cuda")
    err = lib.gru_seq_tc_forward(x_gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                                 h0.data_ptr(), out.data_ptr(), hs.data_ptr(), t, b, hidden,
                                 clusters, rows, int(time_major),
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def inputs(t, b, hidden, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x_gates = torch.randn((t, b, 3 * hidden), generator=g, device="cuda").to(BF16)
    w_hh = (torch.randn((hidden, 3 * hidden), generator=g, device="cuda")
            * (2.0 / (4 * hidden)) ** 0.5).to(BF16)
    return (x_gates, w_hh, torch.randn((3 * hidden,), generator=g, device="cuda"),
            torch.randn((b, hidden), generator=g, device="cuda"))


def time_ms(fn, iters=5, reps=3) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[2048, 1024])
    ap.add_argument("--hidden", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gru_tc_probe: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    src = (_build.CSRC / "gru_seq.cu").read_text()
    copies = {"mma_sync": (src, 16), "one_per_sm": (one_per_sm(src), 16),
              "ieee_gates": (ieee_gates(src), 16), "timers": (with_timers(src), 16),
              "wgmma": (with_wgmma(src), 64),
              "wgmma_timers": (with_timers(with_wgmma(src)), 64)}
    with tempfile.TemporaryDirectory() as out_dir, \
            concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(zip(copies, pool.map(lambda kv: build(kv[0], kv[1][0], out_dir),
                                          copies.items())))
        for name, lib in libs.items():
            rows_multiple = copies[name][1]
            for t, b, hidden in ((30, 17, args.hidden), (1, 17, args.hidden),
                                 (30, 256, args.hidden), (30, 2048, args.hidden),
                                 (30, 17, 128)):
                case = inputs(t, b, hidden, seed=b)
                got = run(lib, rows_multiple, *case)
                bt = run(lib, rows_multiple, case[0].transpose(0, 1).contiguous(), *case[1:],
                         time_major=False).transpose(0, 1)
                want = cuda_gru.gru_recurrence_plain(*case, BF16)
                torch.cuda.synchronize()
                print(json.dumps({"copy": name, "steps": t, "batch": b, "hidden": hidden,
                                  "max_abs_err": (got - want).abs().max().item(),
                                  "bt_equals_b1": bool(torch.equal(bt, got))}), flush=True)
        for b in args.batches:
            case = inputs(30, b, args.hidden, seed=0)
            best = dict.fromkeys(libs, float("inf"))
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    best[name] = min(best[name], time_ms(
                        lambda: run(libs[name], copies[name][1], *case)))
            phases = {}
            for name in ("timers", "wgmma_timers"):
                clocks = (ctypes.c_longlong * 16)()
                libs[name].gru_seq_phase_clocks(clocks)
                phases[name] = {
                    f"warp{w}": dict(zip(("product", "gate_update", "step", "barrier"),
                                         (clocks[o + i] / 30 for i in range(4))))
                    for w, o in ((0, 0), (4, 8))}
            print(json.dumps({"batch": b, "hidden": args.hidden, "ms": best,
                              "clocks_per_step": phases, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
