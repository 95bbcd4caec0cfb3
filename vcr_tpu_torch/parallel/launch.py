"""Start a multi-process run of the command line: one process per device.

    python -m vcr_tpu_torch.parallel.launch --nproc 2 -- --mode train \\
        --mesh_dp 2 --device cpu [cli flags]

starts ``--nproc`` processes, each of which joins one ``torch.distributed``
group (``tcp://localhost:<port>``, a free port unless ``--port`` names one)
with its rank and runs ``vcr_tpu_torch.cli.main`` on the flags after
``--``. The backend is ``mesh.backend_for``'s: NCCL where every process has
a card of its own, gloo on the CPU or for several processes on one card.
Process ``rank`` takes card ``rank % count``. The launcher waits for all of
them and exits with the worst exit code; a signal it receives is passed on
to every process (the train loop then stops all of them at one step).

``--rank R`` runs one process of such a group by hand (all of them need
the same ``--nproc`` and ``--port``).
"""

from __future__ import annotations

import argparse
import signal
import socket
import subprocess
import sys
from typing import List, Optional


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _device_flag(cli_args: List[str]) -> str:
    for i, a in enumerate(cli_args):
        if a == "--device" and i + 1 < len(cli_args):
            return cli_args[i + 1]
        if a.startswith("--device="):
            return a.split("=", 1)[1]
    return "cuda"


def run_rank(rank: int, nproc: int, port: int, cli_args: List[str]):
    """Join the group as ``rank`` of ``nproc`` and run the command line."""
    import torch
    import torch.distributed as dist

    from vcr_tpu_torch import cli
    from vcr_tpu_torch.parallel.mesh import backend_for, device_for

    device = _device_flag(cli_args)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device_for(device, rank))
    dist.init_process_group(backend_for(device, nproc),
                            init_method=f"tcp://localhost:{port}",
                            world_size=nproc, rank=rank)
    try:
        return cli.main(cli_args)
    finally:
        dist.destroy_process_group()


def launch(nproc: int, cli_args: List[str], port: Optional[int] = None) -> int:
    """Start ``nproc`` ranks of ``cli_args`` and wait for them -> the worst
    exit code."""
    port = port or free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "vcr_tpu_torch.parallel.launch",
                               "--nproc", str(nproc), "--port", str(port),
                               "--rank", str(r), "--", *cli_args])
             for r in range(nproc)]

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    previous = {sig: signal.signal(sig, forward) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        return max(p.wait() for p in procs)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cli_args = argv[argv.index("--") + 1:] if "--" in argv else []
    own = argv[:argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--rank", type=int, default=None,
                   help="run this one rank of the group (needs --port)")
    args = p.parse_args(own)
    if args.nproc < 1:
        p.error("--nproc must be >= 1")
    if args.rank is not None:
        if args.port is None:
            p.error("--rank needs --port")
        run_rank(args.rank, args.nproc, args.port, cli_args)
        return 0
    return launch(args.nproc, cli_args, args.port)


if __name__ == "__main__":
    sys.exit(main())
