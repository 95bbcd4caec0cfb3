"""Where the time of the tensor-core LSTM body (kernel B2) goes, and which
geometry it should take.

    python scripts/lstm_tc_probe.py [--batch 1024] [--variants 8:8 8:4 12:4 ...]

Builds copies of ``vcr_tpu_torch/ops/csrc/lstm_seq.cu`` with the flags of
``ops/_build.py`` (plus ``-Xptxas -v``), all at once, into a temporary
directory:

* ``w{W}_a{A}`` -- the source with W warps per CTA (``warps_for``) and
  ``kAhead = A`` k-steps of A loaded ahead, one copy per ``--variants``
  entry ``W:A``;
* ``timers`` -- the source as it is, with clock64() timers around each
  phase of a step (the chunk's operand loads and product, the cell update,
  the cluster barrier), read back for the first and the last warp of the
  first CTA and summed over steps.

Prints, per copy, the registers and spills of the H=512 instantiation,
its error against the plain version (T=30 at B in {17, 256, --batch} both
directions, T=1, and H=128), and then the copies' times at ``--batch``
(T=30, H=512, bf16, one direction, in turns), with the launch geometry of
``cuda_lstm.tc_plan``. Needs a card; the copies are experiments and never
reach the port.
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

from vcr_tpu_torch.ops import _build, cuda_lstm  # noqa: E402

BF16 = torch.bfloat16
ENTRY = re.compile(r"Compiling entry function '([^']+)'")
USED = re.compile(r"Used (\d+) registers")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def _patch(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"lstm_seq.cu changed; anchor not found once: {old[:60]!r}")
    return text.replace(old, new)


def geometry(src: str, warps: int, ahead: int) -> str:
    """The source with ``warps`` warps per CTA at every width."""
    s, n = re.subn(r"constexpr int warps_for\(int groups\) \{ return [^;]+; \}",
                   f"constexpr int warps_for(int groups) {{ return {warps}; }}", src)
    s, m = re.subn(r"constexpr int kAhead = \d+;", f"constexpr int kAhead = {ahead};", s)
    if (n, m) != (1, 1):
        raise RuntimeError("lstm_seq.cu changed; warps_for or kAhead not found once")
    return s


def with_timers(src: str) -> str:
    """Phase timers for the first and the last warp of block 0."""
    s = _patch(src, "namespace {\n", "__device__ long long g_phase[16];\nnamespace {\n")
    s = _patch(s, "  for (int s = 0; s < steps; ++s) {\n    const int t = reverse ? steps - 1 - s : s;\n"
                  "    const uint4* h_cur",
               "  long long p_prod = 0, p_step = 0, p_bar = 0, p_gate = 0;\n"
               "  for (int s = 0; s < steps; ++s) {\n    long long s0 = clock64();\n"
               "    const int t = reverse ? steps - 1 - s : s;\n    const uint4* h_cur")
    s = _patch(s, "      // the cell update's operands first",
               "      long long c0_ = clock64();\n      // the cell update's operands first")
    s = _patch(s, "      // i, f, g, o, the new c and h, in registers\n",
               "      long long c1_ = clock64();\n      p_prod += c1_ - c0_;\n"
               "      // i, f, g, o, the new c and h, in registers\n")
    s = _patch(s, "        store_h(h_next, chunk0 + c, KS, g0 + g, lane, hn[0], hn[1]);\n      }\n",
               "        store_h(h_next, chunk0 + c, KS, g0 + g, lane, hn[0], hn[1]);\n      }\n"
               "      p_gate += clock64() - c1_;\n")
    s = _patch(s, "    if (s + 1 < steps) cluster_sync();\n  }\n}",
               "    long long s1 = clock64();\n    p_step += s1 - s0;\n"
               "    if (s + 1 < steps) cluster_sync();\n    p_bar += clock64() - s1;\n  }\n"
               "  if (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == kThreads - 32)) {\n"
               "    long long* p = g_phase + (threadIdx.x ? 8 : 0);\n"
               "    p[0] = p_prod; p[1] = p_gate; p[2] = p_step; p[3] = p_bar;\n  }\n}")
    return s + ('\nextern "C" int lstm_seq_phase_clocks(long long* out) {\n'
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
        elif entry and "lstm_seq_tc_kernel" in entry and "ILi4E" in entry:
            if (m := USED.search(line)):
                regs["registers"] = int(m.group(1))
            elif (m := SPILL.search(line)):
                regs["spill_stores"], regs["spill_loads"] = int(m.group(1)), int(m.group(2))
    cdll = ctypes.CDLL(str(lib))
    cdll.lstm_seq_tc_forward.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                         + [ctypes.c_void_p])
    cdll.lstm_seq_tc_clusters.argtypes = [ctypes.c_int]
    return cdll, regs


def run(lib, x_gates, w_hh, b_hh, h0, c0, reverse=False):
    t, b = x_gates.shape[:2]
    hidden = w_hh.shape[0]
    _, clusters, rows, _ = cuda_lstm.tc_plan(b, hidden, BF16, lib.lstm_seq_tc_clusters(hidden))
    out = torch.empty((t, b, hidden), device="cuda")
    c_last = torch.empty((b, hidden), device="cuda")
    hs = torch.empty((2, clusters * rows, hidden), dtype=BF16, device="cuda")
    err = lib.lstm_seq_tc_forward(x_gates.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                                  h0.data_ptr(), c0.data_ptr(), out.data_ptr(),
                                  c_last.data_ptr(), hs.data_ptr(), t, b, hidden, clusters,
                                  rows, int(reverse), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out, c_last


def inputs(t, b, hidden, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x_gates = torch.randn((t, b, 4 * hidden), generator=g, device="cuda").to(BF16)
    w_hh = (torch.randn((hidden, 4 * hidden), generator=g, device="cuda")
            * (2.0 / (5 * hidden)) ** 0.5).to(BF16)
    return (x_gates, w_hh, torch.randn((4 * hidden,), generator=g, device="cuda"),
            torch.randn((b, hidden), generator=g, device="cuda"),
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
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--variants", nargs="+", default=["8:8", "12:4", "12:8", "16:2"],
                    help="warps per CTA and k-steps loaded ahead, as W:A")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lstm_tc_probe: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    src = (_build.CSRC / "lstm_seq.cu").read_text()
    copies = {"timers": with_timers(src)}
    for v in args.variants:
        warps, ahead = map(int, v.split(":"))
        copies[f"w{warps}_a{ahead}"] = geometry(src, warps, ahead)
    with tempfile.TemporaryDirectory() as out_dir, \
            concurrent.futures.ThreadPoolExecutor() as pool:
        built = dict(zip(copies, pool.map(lambda kv: build(kv[0], kv[1], out_dir),
                                           copies.items())))
        libs = {name: lib for name, (lib, _) in built.items()}
        for name, (lib, regs) in built.items():
            errs = {}
            for t, b, hidden in ((30, 17, 512), (1, 17, 512), (30, 256, 512),
                                 (30, args.batch, 512), (30, 17, 128)):
                case = inputs(t, b, hidden, seed=b)
                for reverse in (False, True):
                    got = run(lib, *case, reverse=reverse)
                    again = run(lib, *case, reverse=reverse)
                    want = cuda_lstm.lstm_recurrence_plain(*case, BF16, reverse)
                    torch.cuda.synchronize()
                    errs[f"T{t}_B{b}_H{hidden}_{'rev' if reverse else 'fwd'}"] = {
                        "max_abs_err": max((x - y).abs().max().item()
                                           for x, y in zip(got, want)),
                        "twice_equal": all(torch.equal(x, y) for x, y in zip(got, again))}
            print(json.dumps({"copy": name, "h512": regs,
                              "max_clusters_h512": lib.lstm_seq_tc_clusters(512),
                              "checks": errs}), flush=True)
        case = inputs(30, args.batch, 512, seed=0)
        best = dict.fromkeys(libs, float("inf"))
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                best[name] = min(best[name], time_ms(lambda: run(libs[name], *case)))
        clocks = (ctypes.c_longlong * 16)()
        libs["timers"].lstm_seq_phase_clocks(clocks)
        phases = {f"warp{w}": dict(zip(("product", "cell_update", "step", "barrier"),
                                       (clocks[o + i] / 30 for i in range(4))))
                  for w, o in (("_first", 0), ("_last", 8))}
        print(json.dumps({"batch": args.batch, "hidden": 512, "ms": best,
                          "clocks_per_step": phases, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
