"""Card probing for the bench and check entry points.

Counterpart of ``vcr_tpu/utils/backend_probe.py``. A card that is lost or
wedged may not raise: a first CUDA call can block. So the probe runs in a
subprocess under a hard timeout: it makes a small CUDA matmul, reads it back
to the host and checks it, and the parent touches the card only once a
probe has passed. A failed probe ends in one JSON failure line
(:func:`emit_failure_json`) and a nonzero exit, never in a CPU run.

    ok, diag = backend_probe.ensure_backend()
    if not ok:
        backend_probe.emit_failure_json(metric="...", unit="...", diag=diag)
        sys.exit(1)

The JAX module's ``VCR_PROBE_ATTEMPTS``, ``VCR_PROBE_WAIT_S``,
``VCR_PROBE_TIMEOUT_S`` and ``VCR_SKIP_PROBE`` are :func:`ensure_backend`'s
arguments here; nothing reads the environment.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Optional, Tuple

# The smallest call that goes the whole way: the CUDA context, a kernel
# launch, and the result's copy back to the host.
_PROBE_SRC = """
import time; t0 = time.time()
import torch
x = torch.ones((8, 8), device="cuda")
y = (x @ x).cpu()
assert float(y[0, 0]) == 8.0, y[0, 0]
print("PROBE_OK device=%s count=%d dt=%.1fs"
      % (torch.cuda.get_device_name(0), torch.cuda.device_count(), time.time() - t0))
"""


def probe_once(timeout_s: float, env: Optional[dict] = None) -> Tuple[bool, str]:
    """Run one probe in a subprocess -> (ok, a diagnostic line). ``env``
    None inherits this process's environment."""
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE_SRC], capture_output=True,
                           text=True, timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        return False, f"probe timed out after {timeout_s:.0f}s (card hang)"
    if r.returncode == 0 and "PROBE_OK" in r.stdout:
        return True, r.stdout.strip().splitlines()[-1]
    tail = (r.stderr or r.stdout or "").strip().splitlines()
    return False, "probe rc=%d: %s" % (r.returncode, " | ".join(tail[-3:]))


def ensure_backend(attempts: int = 3, wait_s: float = 60.0, timeout_s: float = 240.0,
                   skip: bool = False, verbose: bool = True) -> Tuple[bool, str]:
    """Probe up to ``attempts`` times, ``wait_s`` apart -> (ok, the last
    diagnostic). ``skip`` passes without probing."""
    if skip:
        return True, "probe skipped"
    diag = "no attempts made"
    for i in range(attempts):
        ok, diag = probe_once(timeout_s)
        if verbose:
            print(f"[backend_probe] attempt {i + 1}/{attempts}: {diag}", file=sys.stderr)
        if ok:
            return True, diag
        if i + 1 < attempts:
            time.sleep(wait_s)
    return False, diag


def emit_failure_json(metric: str, unit: str, diag: str) -> None:
    """One JSON line that a bench's log keeps in place of a traceback."""
    print(json.dumps({
        "metric": metric,
        "value": None,
        "unit": unit,
        "vs_baseline": None,
        "error": "CUDA card unavailable after probe retries",
        "diagnostic": diag[:500],
    }), flush=True)
