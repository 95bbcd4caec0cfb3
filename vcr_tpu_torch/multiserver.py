"""Multi-model caption serving: one HTTP daemon in front of several pools,
the counterpart of ``vcr_tpu/multiserver.py``.

A serving host often carries more than one model: families for different
corpora, an A/B pair, a beam pool next to a sampling pool. This daemon
routes one port across N continuous-batching backends, each a headless
CaptionServer (its own scheduler thread, request queue, cancel set, bounds:
``server.CaptionServer(http=False)``), so every per-model behaviour
(back-pressure, timeout cancellation, per-request sampling, shape
validation) is exactly the single-model daemon's. The N scheduler threads
launch onto the same card, where their kernels interleave; an idle pool
blocks on its queue and costs the card nothing.

API (the single-model endpoints, one path segment deeper):
  POST /caption/<model>[?temperature=&top_k=&top_p=]
  POST /caption_batch/<model>
  GET  /models    -> {"models": {name: {arch, slots, beam_size}}}
  GET  /healthz   -> {"status", "models": {name: per-model health}}
                  (503 if ANY backend's scheduler died)
  GET  /metrics   -> one Prometheus exposition, samples labeled
                  model="<name>" (HELP/TYPE emitted once per metric)
  POST /profile?seconds=S -> one torch.profiler trace, captured on the first
                  model's scheduler thread: its operations, and every
                  model's kernels on the card; opt-in via profile_dir, as
                  in CaptionServer.

Usage:
    ms = MultiCaptionServer({"s2vt": (cc1, vocab1),
                             "tf-beam": (cc2, vocab2)}, port=8000)
    ms.start()
    ...
    ms.close()

CLI: ``--mode serve --serve_models name1=path1,name2=path2`` where each path
is a checkpoint save_path: see tools.serve_captions.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple, Union

from vcr_tpu_torch.server import (CaptionServer, check_auth, handle_caption_post,
                                  parse_profile_seconds, write_prometheus)

_NAME_RE = re.compile(r"[A-Za-z0-9_.\-]{1,64}")


class MultiCaptionServer:
    """See module docstring. ``backends``: {name: captioner} or
    {name: (captioner, vocab)}. Per-request bounds/timeouts apply per
    backend (each holds its own max_pending etc.)."""

    def __init__(self, backends: Dict[str, Union[object, Tuple]],
                 host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 120.0,
                 max_pending: Optional[int] = None,
                 profile_dir: Optional[str] = None,
                 auth_token: Optional[str] = None,
                 max_body_mb: float = 256.0):
        if not backends:
            raise ValueError("need at least one model backend")
        self.auth_token = auth_token
        self.servers: Dict[str, CaptionServer] = {}
        for name, spec in backends.items():
            if not _NAME_RE.fullmatch(name):
                raise ValueError(
                    f"model name {name!r} must match {_NAME_RE.pattern}")
            cap, vocab = spec if isinstance(spec, tuple) else (spec, None)
            self.servers[name] = CaptionServer(
                cap, vocab=vocab, request_timeout_s=request_timeout_s,
                max_pending=max_pending, profile_dir=profile_dir,
                http=False, auth_token=auth_token, max_body_mb=max_body_mb)
        # one profile guard across the routes: a capture sees every model's
        # kernels on the card
        self.profile_dir = profile_dir
        self._profiling = False
        self._lock = threading.Lock()

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code: int, payload: dict, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/models":
                    return self._json(200, {"models": {
                        name: {"arch": outer._arch(s),
                               "slots": s.captioner.slots,
                               "beam_size": getattr(s.captioner,
                                                    "beam_size", 1)}
                        for name, s in outer.servers.items()}})
                if self.path == "/metrics":
                    return write_prometheus(self, outer.servers)
                if self.path != "/healthz":
                    return self._json(404, {"error": "unknown path"})
                models = {}
                any_err = False
                for name, s in outer.servers.items():
                    st = dict(s.captioner.stats,
                              in_flight=s.captioner.in_flight,
                              rejected=s._rejected,
                              status="error" if s.error else "ok",
                              error=s.error)
                    p50, p95 = s._latency_quantiles()
                    if p50 is not None:
                        st["latency_p50_ms"] = round(1e3 * p50, 2)
                        st["latency_p95_ms"] = round(1e3 * p95, 2)
                    any_err |= s.error is not None
                    models[name] = st
                self._json(503 if any_err else 200,
                           {"status": "error" if any_err else "ok",
                            "models": models})

            def do_POST(self):
                from urllib.parse import urlsplit

                parts = urlsplit(self.path)
                if parts.path == "/profile":
                    # delegate to any backend's capture (process-global
                    # trace) behind the one multi-level guard
                    if not check_auth(self, outer.auth_token):
                        return
                    try:
                        seconds = parse_profile_seconds(parts.query)
                    except ValueError as e:
                        return self._json(400, {"error": str(e)})
                    code, payload = outer._capture_profile(seconds)
                    return self._json(code, payload)
                seg = parts.path.split("/")
                if len(seg) != 3 or seg[1] not in ("caption",
                                                   "caption_batch"):
                    return self._json(404, {
                        "error": "POST /caption/<model> or "
                                 "/caption_batch/<model> (GET /models "
                                 "lists them)"})
                s = outer.servers.get(seg[2])
                if s is None:
                    return self._json(404, {
                        "error": f"unknown model {seg[2]!r}; serving "
                                 f"{sorted(outer.servers)}"})
                # the whole caption flow (sampling-query validation, opts
                # capability check, body parse, submit, error mapping) is
                # the single-model daemon's, verbatim
                handle_caption_post(self, s, parts,
                                    batch=seg[1] == "caption_batch")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="vcr-multicaption-http")

    @staticmethod
    def _arch(s: CaptionServer) -> str:
        spec = getattr(s.captioner, "spec", None)
        if spec is not None:
            return spec.arch
        meta = getattr(s.captioner, "meta", None)  # a frozen artifact
        return meta["spec"]["arch"] if meta else "unknown"

    def _capture_profile(self, seconds: float):
        """One process-global capture guard across every model route."""
        if not self.profile_dir:
            return 403, {"error": "profiling disabled (profile_dir= / "
                                  "--serve_profile_dir)"}
        with self._lock:
            if self._profiling:
                return 409, {"error": "a profile capture is already running"}
            self._profiling = True
        try:
            # the first backend's scheduler thread runs the capture
            return next(iter(self.servers.values()))._capture_profile(
                seconds)
        finally:
            with self._lock:
                self._profiling = False

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "MultiCaptionServer":
        for s in self.servers.values():
            s.start()
        self._http_thread.start()
        return self

    def close(self):
        self._httpd.shutdown()
        for s in self.servers.values():
            s.close()
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
