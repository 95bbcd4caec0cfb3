"""Where a step of kernel B4's tensor-core body goes, and which geometry it
should take.

    python scripts/gru_dma_tc_probe.py [--batches 2048 1024]
        [--variants 8:2 10:2 12:2 10:3 10:2:8 ...]

Builds copies of ``vcr_tpu_torch/ops/csrc/gru_seq_dma.cu`` with the flags
of ``ops/_build.py`` (plus ``-Xptxas -v``), all at once, into a temporary
directory:

* ``w{W}_k{K}[_a{A}]`` -- the source with W warps per CTA (``kWarps``), K
  ``x_gates`` slots in each warp's ring (``kSlots``) and, if given, A
  k-steps of the product's A operand loaded ahead (``kAhead``), one copy
  per ``--variants`` entry ``W:K[:A]``;
* ``timers`` -- the source as it is, with clock64() timers around each
  phase of an item (one chunk in one step): the wait on the ``x_gates``
  slot's mbarrier, the product (with its operand loads), the gate update,
  the wait for the warp's earlier stores to have read their tiles, and the
  tile write with its store; and around the cluster barrier. Read back for
  the first and the last warp of the first CTA, summed over steps.

Prints, per copy, the registers and spills of the H=512 instantiation, its
error against the plain version and whether it equals kernel B1 bit for bit
(T=30 at B in {17, 256, 2048}, T=1, and H=128), and then the copies' times
at each batch (T=30, H=512, bf16) in turns with B1's, with the launch
geometry of ``cuda_gru.dma_tc_plan`` (a copy whose buffers do not fit at a
batch is reported so and not timed). Needs a card; the copies are
experiments and never reach the port.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vcr_tpu_torch.ops import _build, cuda_gru  # noqa: E402

BF16 = torch.bfloat16
ENTRY = re.compile(r"Compiling entry function '([^']+)'")
USED = re.compile(r"Used (\d+) registers")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PHASES = ("x_wait", "product", "gate_update", "store_wait", "tile_out", "step", "barrier")


def _patch(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"gru_seq_dma.cu changed; anchor not found once: {old[:60]!r}")
    return text.replace(old, new)


def geometry(src: str, warps: int, slots: int, ahead: int = 0) -> str:
    """The source with ``warps`` warps per CTA, ``slots`` ring slots per
    warp and, if ``ahead``, that many k-steps of A loaded ahead."""
    s = src
    for name, value in (("kWarps", warps), ("kSlots", slots), ("kAhead", ahead)):
        if value:
            s, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", s)
            if n != 1:
                raise RuntimeError(f"gru_seq_dma.cu changed; {name} not found once")
    return s


def with_timers(src: str) -> str:
    """Phase timers for lane 0 of the first and the last warp of block 0."""
    s = _patch(src, "namespace {\n", "__device__ long long g_phase[16];\nnamespace {\n")
    s = _patch(s, "  int i = 0;  // this warp's item\n  for (int t = 0; t < steps; ++t) {\n",
               "  long long p[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
               "  int i = 0;  // this warp's item\n  for (int t = 0; t < steps; ++t) {\n"
               "    const long long s0 = clock64();\n")
    s = _patch(s, "      // the (i / kSlots)-th use of slot s",
               "      const long long c0 = clock64();\n      // the (i / kSlots)-th use of slot s")
    s = _patch(s, "      uint32_t xw[kGroups][3][2];",
               "      const long long c1 = clock64();\n      p[0] += c1 - c0;\n"
               "      uint32_t xw[kGroups][3][2];")
    s = _patch(s, "      // r, z, n and the new h, in registers\n",
               "      const long long c2 = clock64();\n      p[1] += c2 - c1;\n"
               "      // r, z, n and the new h, in registers\n")
    s = _patch(s, "      // the warp's earlier stores have read their tiles",
               "      const long long c3 = clock64();\n      p[2] += c3 - c2;\n"
               "      // the warp's earlier stores have read their tiles")
    s = _patch(s, "      __syncwarp();\n#pragma unroll\n      for (int g = 0; g < kGroups; ++g) {\n"
                  "#pragma unroll\n        for (int hh = 0; hh < 2; ++hh)\n"
                  "          *reinterpret_cast<float2*>(tile",
               "      __syncwarp();\n      const long long c4 = clock64();\n      p[3] += c4 - c3;\n"
               "#pragma unroll\n      for (int g = 0; g < kGroups; ++g) {\n"
               "#pragma unroll\n        for (int hh = 0; hh < 2; ++hh)\n"
               "          *reinterpret_cast<float2*>(tile")
    s = _patch(s, "      if (lane == 0) tma_store_4d(&out_map, tile, 0, row0 + c * kChunk, g0, t);\n"
                  "    }\n",
               "      if (lane == 0) tma_store_4d(&out_map, tile, 0, row0 + c * kChunk, g0, t);\n"
               "      p[4] += clock64() - c4;\n    }\n")
    s = _patch(s, "    if (t + 1 < steps) cluster_sync();\n  }\n"
                  "  if (lane == 0) asm volatile(\"cp.async.bulk.wait_group 0;\" ::: \"memory\");\n}",
               "    const long long s1 = clock64();\n    p[5] += s1 - s0;\n"
               "    if (t + 1 < steps) cluster_sync();\n    p[6] += clock64() - s1;\n  }\n"
               "  if (lane == 0) asm volatile(\"cp.async.bulk.wait_group 0;\" ::: \"memory\");\n"
               "  if (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == kThreads - 32)) {\n"
               "    long long* o = g_phase + (threadIdx.x ? 8 : 0);\n"
               "    for (int k = 0; k < 7; ++k) o[k] = p[k];\n    o[7] = i;\n  }\n}")
    return s + ('\nextern "C" int gru_seq_dma_phase_clocks(long long* out) {\n'
                "  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n")


def build(name: str, text: str, out_dir: str):
    src = Path(out_dir) / f"{name}.cu"
    src.write_text(text)
    lib = Path(out_dir) / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-Xptxas", "-v", "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    # registers and spills of the H=512 instantiation (kGroups = 4)
    regs, entry = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        if (m := ENTRY.search(line)):
            entry = m.group(1)
        elif entry and "gru_seq_dma_tc_kernel" in entry and "ILi4E" in entry:
            if (m := USED.search(line)):
                regs["registers"] = int(m.group(1))
            elif (m := SPILL.search(line)):
                regs["spill_stores"], regs["spill_loads"] = int(m.group(1)), int(m.group(2))
    cdll = ctypes.CDLL(str(lib))
    cdll.gru_seq_dma_tc_forward.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                            + [ctypes.c_void_p])
    cdll.gru_seq_dma_tc_clusters.argtypes = [ctypes.c_int]
    return cdll, regs


def plan(lib, geom, b, hidden):
    return cuda_gru.dma_tc_plan(b, hidden, BF16, lib.gru_seq_dma_tc_clusters(hidden), *geom)


def run(lib, geom, x_gates, w_hh, b_hh, h0):
    t, b = x_gates.shape[:2]
    hidden = w_hh.shape[0]
    _, clusters, rows, _, warps, slots = plan(lib, geom, b, hidden)
    out = torch.empty((t, b, hidden), device="cuda")
    hs = torch.empty((2, clusters * rows, hidden), dtype=BF16, device="cuda")
    err = lib.gru_seq_dma_tc_forward(x_gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                                     h0.data_ptr(), out.data_ptr(), hs.data_ptr(), t, b,
                                     hidden, clusters, rows, warps, slots,
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
    ap.add_argument("--variants", nargs="+",
                    default=["8:2", "10:2", "12:2", "10:3", "10:2:8", "12:2:8"],
                    help="warps per CTA, ring slots per warp and optionally k-steps of "
                         "A loaded ahead, as W:K[:A]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gru_dma_tc_probe: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    src = (_build.CSRC / "gru_seq_dma.cu").read_text()
    shipped = (cuda_gru.DMA_TC_WARPS, cuda_gru.DMA_TC_SLOTS)
    copies = {"timers": (with_timers(src), shipped)}
    for v in args.variants:
        w, k, *a = map(int, v.split(":"))
        copies[f"w{w}_k{k}" + (f"_a{a[0]}" if a else "")] = (geometry(src, w, k, *a), (w, k))
    with tempfile.TemporaryDirectory() as out_dir, \
            concurrent.futures.ThreadPoolExecutor() as pool:
        built = dict(zip(copies, pool.map(lambda kv: build(kv[0], kv[1][0], out_dir),
                                           copies.items())))
        libs = {name: (lib, copies[name][1]) for name, (lib, _) in built.items()}
        for name, (lib, regs) in built.items():
            geom = copies[name][1]
            checks = {}
            for t, b, hidden in ((30, 17, 512), (1, 17, 512), (30, 256, 512),
                                 (30, 2048, 512), (30, 17, 128)):
                if plan(lib, geom, b, hidden) is None:
                    checks[f"T{t}_B{b}_H{hidden}"] = "does not fit"
                    continue
                case = inputs(t, b, hidden, seed=b)
                got = run(lib, geom, *case)
                again = run(lib, geom, *case)
                b1 = cuda_gru.gru_recurrence_cuda(*case, BF16)
                want = cuda_gru.gru_recurrence_plain(*case, BF16)
                torch.cuda.synchronize()
                checks[f"T{t}_B{b}_H{hidden}"] = {
                    "max_abs_err": (got - want).abs().max().item(),
                    "equal_b1": torch.equal(got, b1), "twice_equal": torch.equal(got, again)}
            print(json.dumps({"copy": name, "warps": geom[0], "slots": geom[1], "h512": regs,
                              "max_clusters_h512": lib.gru_seq_dma_tc_clusters(512),
                              "checks": checks}), flush=True)
        for b in args.batches:
            case = inputs(30, b, 512, seed=0)
            runs = {"b1": lambda: cuda_gru.gru_recurrence_cuda(*case, BF16)}
            unfit = []
            for name, (lib, geom) in libs.items():
                if plan(lib, geom, b, 512) is None:
                    unfit.append(name)
                else:
                    runs[name] = lambda lib=lib, geom=geom: run(lib, geom, *case)
            best = dict.fromkeys(runs, float("inf"))
            for order in (list(runs), list(runs)[::-1]):
                for name in order:
                    best[name] = min(best[name], time_ms(runs[name]))
            record = {"batch": b, "hidden": 512, "ms": best, "does_not_fit": unfit,
                      "plans": {name: plan(lib, geom, b, 512) for name, (lib, geom) in libs.items()}}
            if "timers" in runs:
                clocks = (ctypes.c_longlong * 16)()
                libs["timers"][0].gru_seq_dma_phase_clocks(clocks)
                record["clocks_per_step"] = {
                    f"warp_{w}": {**{k: clocks[o + i] / 30 for i, k in enumerate(PHASES)},
                                  "items": clocks[o + 7]}
                    for w, o in (("first", 0), ("last", 8))}
            print(json.dumps({**record, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
