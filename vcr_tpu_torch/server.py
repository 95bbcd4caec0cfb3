"""HTTP caption-serving daemon over the continuous-batching slot pool: the
counterpart of ``vcr_tpu/server.py``.

A thin stdlib-only (http.server + threading) front end for
``serving_continuous.ContinuousCaptioner``: HTTP handler threads parse numpy
bodies, enqueue requests and wait on per-request events; ONE scheduler
thread makes every call that reaches the card, driving ``caption_stream``
over a live queue with the poll-marker protocol (``None`` = nothing
available, keep ticking in-flight slots). So requests from many clients
batch onto the card, and no lock guards device state. The pool's operations
enter ``torch.inference_mode()`` themselves, on the scheduler thread's
default stream.

API:
  POST /caption   body = raw .npy bytes of (num_frames, feat_dim) float32
                  (client: ``np.save(buf, feats)``)
                  -> {"tokens": [...], "caption": "..."}   (caption iff the
                  server was built with a vocab)
                  Optional query params ?temperature=&top_k=&top_p= set
                  per-request sampling when the pool was built with
                  sampling enabled (request_sampling /
                  --serve_request_sampling / --sample_temperature); 400
                  otherwise.
  POST /caption_batch  body = raw .npy bytes of (B, num_frames, feat_dim)
                  float32: the whole batch rides one request; rows fill
                  slots by admission chunks -> {"results": [row | null,
                  ...]} in input order (null = that row timed out). Same
                  optional sampling query params, applied to every row.
                  B may exceed max_pending: the server drains it in
                  sequential waves of max_pending rows.
  GET  /healthz   -> {"status": "ok", "in_flight": N, ...scheduler stats}
  POST /profile?seconds=S  capture a torch.profiler trace of live serving
                  (the scheduler thread's operations and the card's
                  kernels) for S seconds (cap 60), with the program's spans
                  (``utils.profiling``: the pool's rounds and every other
                  thread's), written as a Chrome trace
                  trace.json under a new directory of profile_dir
                  -> {"trace_dir": ..., "seconds": S}; requires the server
                  to be built with profile_dir= (--serve_profile_dir), 403
                  otherwise; 409 while a capture is already running
  GET  /metrics   -> Prometheus text exposition (counters for every
                  scheduler stat, occupancy + in-flight gauges, a request-
                  latency summary)

Usage:
    server = CaptionServer(captioner, vocab=vocab, port=8000)
    server.start()           # returns immediately; .port holds the bind
    ...
    server.close()

Auth: ``auth_token`` (``--serve_auth_token``) gates every POST route behind
"Authorization: Bearer <token>" (401 otherwise); /healthz and /metrics stay
open for load-balancer probes and scrapers. ``max_body_mb`` bounds request
bodies (413): an unbounded read of a hostile Content-Length is a memory DoS.

Production bounds: ``max_pending`` caps outstanding requests (queued +
in-flight); beyond it POST /caption returns 503 + Retry-After instead of
queueing without bound (each queued HTTP request holds a handler thread). A
request whose client times out is cancelled: its rid lands in a cancel set
the scheduler sweeps each round (run_slot_scheduler poll_cancelled), so a
queued request is dropped before admission and an in-flight one has its slot
released (ContinuousCaptioner.release_slots). If the scheduler thread
raises, ``error`` records it and every waiting client is released (504).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from vcr_tpu_torch.utils import profiling


class ServerOverloaded(Exception):
    """submit() rejection: outstanding requests hit ``max_pending``. The HTTP
    layer maps it to 503 + Retry-After; direct submit() callers should back
    off and retry."""


def parse_sampling_query(query: str) -> Optional[dict]:
    """?temperature=&top_k=&top_p= -> a per-request opts dict (None when the
    query string is empty). Raises ValueError on unknown params or values
    outside their safe ranges — validated HERE at the API layer because bad
    values on the scheduler thread kill the daemon: top_k past int32 raised
    OverflowError in the per-slot array scatter, and NaN temperature slips
    past a plain ``t <= 0`` greedy check (NaN comparisons are all False).
    keep_blank_values so '?temperature=' is a loud 400, not silently greedy.
    """
    from urllib.parse import parse_qsl

    if not query:
        return None
    q = dict(parse_qsl(query, keep_blank_values=True))
    opts = {}
    if "temperature" in q:
        t = float(q["temperature"])
        if not (0.0 <= t < float("inf")):
            raise ValueError(
                f"temperature must be finite and >= 0, got "
                f"{q['temperature']}")
        opts["temperature"] = t
    if "top_k" in q:
        k = int(q["top_k"])
        if not 0 <= k < 2**31:
            raise ValueError(f"top_k must be in [0, 2^31), got {k}")
        opts["top_k"] = k
    if "top_p" in q:
        tp = float(q["top_p"])
        if not 0.0 <= tp <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {q['top_p']}")
        opts["top_p"] = tp
    unknown = set(q) - {"temperature", "top_k", "top_p"}
    if unknown:
        raise ValueError(f"unknown query params {sorted(unknown)}")
    return opts


def parse_profile_seconds(query: str) -> float:
    """?seconds=S for POST /profile (default 3, bounded (0, 60]); raises
    ValueError on unknown params or out-of-range values."""
    from urllib.parse import parse_qsl

    q = dict(parse_qsl(query, keep_blank_values=True))
    seconds = float(q.pop("seconds", 3.0))
    if q:
        raise ValueError(f"unknown query params {sorted(q)}")
    if not 0 < seconds <= 60:
        raise ValueError(f"seconds must be in (0, 60], got {seconds}")
    return seconds


def check_auth(handler, auth_token: Optional[str]) -> bool:
    """Bearer-token gate for the mutating routes (caption/profile). True =
    allowed; False = a 401 response was already written. /healthz and
    /metrics stay open (load-balancer probes and scrapers don't carry app
    tokens). Constant-time comparison — an equality short-circuit would
    leak prefix length to a timing probe."""
    if not auth_token:
        return True
    import hmac

    got = handler.headers.get("Authorization", "")
    if got.startswith("Bearer ") and hmac.compare_digest(got[7:],
                                                         auth_token):
        return True
    handler._json(401, {"error": "missing or invalid bearer token"},
                  headers={"WWW-Authenticate": "Bearer"})
    return False


def read_body(handler, max_body_mb: float):
    """Read the request body bounded by ``max_body_mb`` (raises ValueError
    with an HTTP status hint on violation) — an unbounded rfile.read of a
    hostile Content-Length is a memory DoS."""
    length = int(handler.headers.get("Content-Length", "0"))
    if length < 0:
        raise ValueError("negative Content-Length")
    if max_body_mb and length > max_body_mb * 1024 * 1024:
        raise ValueError(
            f"body of {length} bytes exceeds the server's "
            f"{max_body_mb:g} MiB limit")
    return handler.rfile.read(length)


def handle_caption_post(handler, backend: "CaptionServer", parts,
                        batch: bool) -> None:
    """The POST /caption and /caption_batch flow, shared verbatim by the
    single-model daemon and every route of the multi-model daemon (any fix
    here fixes both): auth, sampling-query validation, opts capability
    check, bounded .npy body parse, submit/submit_many, error mapping,
    payload build. ``handler`` is the live BaseHTTPRequestHandler (must
    expose _json)."""
    if not check_auth(handler, backend.auth_token):
        return
    try:
        opts = parse_sampling_query(parts.query)
    except ValueError as e:
        return handler._json(400, {"error": str(e)})
    if opts and not getattr(backend.captioner, "accepts_request_opts",
                            False):
        return handler._json(400, {
            "error": "per-request sampling params need a pool built with "
                     "sampling enabled (--serve_request_sampling true or "
                     "--sample_temperature > 0; beam pools do not accept "
                     "them)"})
    try:
        body = read_body(handler, backend.max_body_mb)
    except ValueError as e:
        return handler._json(413, {"error": str(e)})
    try:
        feats = np.load(io.BytesIO(body), allow_pickle=False)
    except Exception as e:
        return handler._json(400, {"error": f"bad .npy body: {e}"})

    def row_payload(toks):
        if toks is None:
            return None
        p = {"tokens": [int(t) for t in toks]}
        if backend.vocab is not None:
            p["caption"] = backend.vocab.get_sent_from_index(
                [int(t) for t in toks])
        return p

    try:
        if batch:
            rows = backend.submit_many(feats, opts=opts)
            return handler._json(200,
                                 {"results": [row_payload(t) for t in rows]})
        toks = backend.submit(feats, opts=opts)
    except ServerOverloaded as e:
        return handler._json(503, {"error": str(e)},
                             headers={"Retry-After": "1"})
    except ValueError as e:
        return handler._json(400, {"error": str(e)})
    if toks is None:
        return handler._json(504, {"error": "caption timed out"})
    handler._json(200, row_payload(toks))


def write_prometheus(handler, servers: dict) -> None:
    """GET /metrics response writer shared by both daemons."""
    body = prometheus_text(servers).encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; version=0.0.4")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def prometheus_text(servers: dict) -> str:
    """Valid Prometheus text exposition over one or many model backends.
    ``servers``: {label: CaptionServer}; the single-model daemon passes
    {"": self} (no labels), the multi-model daemon one entry per model
    (samples labeled ``model="name"``). HELP/TYPE emitted once per metric
    name — repeating them per model would be an invalid exposition."""
    names = list(servers)
    per = {lb: servers[lb]._metric_samples() for lb in names}
    lines = []
    for i, (name, mtype, help_, _v) in enumerate(per[names[0]]):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {mtype}")
        for lb in names:
            label = f'{{model="{lb}"}}' if lb else ""
            lines.append(f"{name}{label} {per[lb][i][3]}")
    lines.append("# HELP vcr_request_latency_seconds "
                 "submit-to-caption wall time")
    lines.append("# TYPE vcr_request_latency_seconds summary")
    for lb in names:
        s = servers[lb]
        base = f'model="{lb}",' if lb else ""
        p50, p95 = s._latency_quantiles()
        if p50 is not None:
            lines.append(f'vcr_request_latency_seconds{{{base}quantile="0.5"}}'
                         f" {p50:.6f}")
            lines.append(
                f'vcr_request_latency_seconds{{{base}quantile="0.95"}}'
                f" {p95:.6f}")
        label = f'{{model="{lb}"}}' if lb else ""
        with s._lock:
            lines.append(f"vcr_request_latency_seconds_sum{label} "
                         f"{s._lat_sum:.6f}")
            lines.append(f"vcr_request_latency_seconds_count{label} "
                         f"{s._lat_count}")
    return "\n".join(lines) + "\n"


class CaptionServer:
    """See module docstring. ``captioner`` is a ContinuousCaptioner (any
    family); ``vocab`` (optional) adds detokenized captions to responses.
    ``max_pending`` bounds outstanding requests (default 4x the pool's slot
    count; 0 disables the bound)."""

    def __init__(self, captioner, vocab=None, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 120.0,
                 max_pending: Optional[int] = None,
                 profile_dir: Optional[str] = None, http: bool = True,
                 auth_token: Optional[str] = None,
                 max_body_mb: float = 256.0):
        self.captioner = captioner
        self.vocab = vocab
        self.request_timeout_s = request_timeout_s
        self.max_pending = (4 * captioner.slots if max_pending is None
                            else max_pending)
        # POST routes require "Authorization: Bearer <auth_token>" when set
        # (healthz/metrics stay open for probes/scrapers); bodies above
        # max_body_mb are refused with 413 (0 disables the bound)
        self.auth_token = auth_token
        self.max_body_mb = max_body_mb
        self.profile_dir = profile_dir
        self._profiling = False
        # /profile capture jobs, run by the scheduler thread
        self._profile_jobs: queue.Queue = queue.Queue()
        self._profile_job: Optional[dict] = None
        self._rejected = 0
        self._cancelled: set = set()
        self._queue: queue.Queue = queue.Queue()
        self._events: dict = {}
        self._tokens: dict = {}
        self._done_at: dict = {}  # rid -> harvest time (true per-row latency)
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._feat_shape = None
        self.error: Optional[str] = None
        # ring of the last 512 request latencies (submit -> caption), for
        # /healthz p50/p95 — enough for a live dashboard, bounded memory
        self._latencies: list = []
        # lifetime latency aggregates for the /metrics summary (the ring
        # above is windowed; Prometheus counters must be monotone)
        self._lat_sum = 0.0
        self._lat_count = 0

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
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
                if self.path == "/metrics":
                    return write_prometheus(self, {"": server})
                if self.path != "/healthz":
                    return self._json(404, {"error": "unknown path"})
                stats = dict(server.captioner.stats,
                             in_flight=server.captioner.in_flight,
                             rejected=server._rejected,
                             status="error" if server.error else "ok",
                             error=server.error)
                p50, p95 = server._latency_quantiles()
                if p50 is not None:
                    stats["latency_p50_ms"] = round(1e3 * p50, 2)
                    stats["latency_p95_ms"] = round(1e3 * p95, 2)
                # 503 on a dead scheduler: the conventional "unhealthy"
                # signal load-balancer probes act on
                self._json(503 if server.error else 200, stats)

            def do_POST(self):
                from urllib.parse import urlsplit

                parts = urlsplit(self.path)
                if parts.path == "/profile":
                    if not check_auth(self, server.auth_token):
                        return
                    try:
                        seconds = parse_profile_seconds(parts.query)
                    except ValueError as e:
                        return self._json(400, {"error": str(e)})
                    code, payload = server._capture_profile(seconds)
                    return self._json(code, payload)
                if parts.path not in ("/caption", "/caption_batch"):
                    return self._json(404, {"error": "unknown path"})
                handle_caption_post(self, server, parts,
                                    batch=parts.path == "/caption_batch")

        # http=False runs headless: submit()/submit_many() + the scheduler
        # thread with no socket — the per-model backend of MultiCaptionServer
        self._httpd = (ThreadingHTTPServer((host, port), Handler)
                       if http else None)
        self.port = self._httpd.server_address[1] if http else None
        self._sched = threading.Thread(target=self._scheduler, daemon=True,
                                       name="vcr-caption-scheduler")
        self._http_thread = (threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="vcr-caption-http") if http else None)

    # -------------------------------------------------------------- plumbing

    def submit(self, feats: np.ndarray, opts: Optional[dict] = None
               ) -> Optional[np.ndarray]:
        """Enqueue one request and block until its caption (or timeout /
        server shutdown -> None). Thread-safe; usable directly without HTTP.
        ``opts`` carries per-request options (sampling params) to pools that
        accept them. Raises ValueError on a feature-shape mismatch (all
        requests must share one shape — the slot pool is fixed-shape by
        design) and ServerOverloaded when outstanding requests hit
        ``max_pending``. A timed-out request is cancelled scheduler-side
        (queued: dropped; in-flight: slot released)."""
        if opts and not getattr(self.captioner, "accepts_request_opts",
                                False):
            raise ValueError("this pool does not accept per-request options")
        feats = np.asarray(feats, np.float32)
        rid = uuid.uuid4().hex
        ev = threading.Event()
        with self._lock:
            # bound-check and register under ONE lock hold: checking in a
            # separate critical section would let M concurrent submits all
            # pass the check and overshoot the cap by M-1
            if self.max_pending and len(self._events) >= self.max_pending:
                self._rejected += 1
                raise ServerOverloaded(
                    f"{len(self._events)} requests outstanding >= "
                    f"max_pending={self.max_pending}")
            if self._feat_shape is None:
                # validate against the pool's spec BEFORE adopting: blindly
                # adopting a malformed first request's shape would crash the
                # encode on the scheduler thread and kill the daemon
                check = getattr(self.captioner, "check_feat_shape", None)
                reason = check(feats.shape) if check else None
                if reason is not None:
                    raise ValueError(reason)
                self._feat_shape = feats.shape
            elif feats.shape != self._feat_shape:
                raise ValueError(
                    f"feature shape {feats.shape} != this server's "
                    f"{self._feat_shape}")
            self._events[rid] = ev
        t0 = time.monotonic()
        self._queue.put((rid, feats, opts) if opts else (rid, feats))
        ev.wait(self.request_timeout_s)
        with self._lock:
            self._events.pop(rid, None)
            # pop unconditionally: the scheduler may have harvested between
            # ev.wait timing out and us reacquiring the lock — leaving the
            # entry would leak it forever. If the caption DID land in that
            # window, return it (the client is still connected).
            toks = self._tokens.pop(rid, None)
            done_at = self._done_at.pop(rid, None)
            if toks is None and not self._stopping.is_set():
                # client gives up: reclaim the request's queue entry / slot
                self._cancelled.add(rid)
            if toks is not None:
                self._record_latency((done_at or time.monotonic()) - t0)
            return toks

    def _record_latency(self, dt: float) -> None:
        """Caller holds self._lock."""
        self._latencies.append(dt)
        self._lat_sum += dt
        self._lat_count += 1
        if len(self._latencies) > 512:
            del self._latencies[:256]

    def submit_many(self, feats_batch: np.ndarray,
                    opts: Optional[dict] = None) -> list:
        """Enqueue a whole (B, *item_shape) batch (POST /caption_batch) and
        block until every caption or the per-wave deadline
        (``request_timeout_s``). Returns a length-B list with None for rows
        that timed out (those are cancelled scheduler-side). A batch larger
        than max_pending is processed in sequential WAVES of max_pending
        rows — an arbitrarily large offline corpus drains through a bounded
        daemon instead of being unserveable. Within a wave, one admission
        check covers all rows: wave + outstanding must fit max_pending or
        the wave is refused whole (ServerOverloaded, genuinely transient —
        retry after backoff) — a half-admitted wave would be worse than a
        clean retry. Per-row latencies are recorded at HARVEST time (the
        scheduler stamps completion), not at batch drain."""
        if opts and not getattr(self.captioner, "accepts_request_opts",
                                False):
            raise ValueError("this pool does not accept per-request options")
        fb = np.asarray(feats_batch, np.float32)
        if fb.ndim < 2 or len(fb) == 0:
            raise ValueError(
                f"need a non-empty (B, ...) feature batch, got {fb.shape}")
        wave = self.max_pending or len(fb)
        out = []
        for start in range(0, len(fb), wave):
            rows = fb[start: start + wave]
            try:
                out.extend(self._submit_wave(rows, opts))
            except ServerOverloaded:
                if start == 0:
                    # nothing admitted yet: a clean whole-batch reject the
                    # client can safely retry
                    raise
                # later waves: other traffic filled the bound mid-batch —
                # raising here would discard the completed waves' results,
                # so wait for headroom up to one wave-timeout, then give the
                # remainder up as row-nulls (the documented timeout shape)
                deadline = time.monotonic() + self.request_timeout_s
                while True:
                    time.sleep(0.05)
                    try:
                        out.extend(self._submit_wave(rows, opts))
                        break
                    except ServerOverloaded:
                        if time.monotonic() >= deadline:
                            out.extend([None] * len(rows))
                            break
        return out

    def _submit_wave(self, fb: np.ndarray, opts: Optional[dict]) -> list:
        b = len(fb)
        item_shape = fb.shape[1:]
        rids = [uuid.uuid4().hex for _ in range(b)]
        evs = [threading.Event() for _ in range(b)]
        with self._lock:
            if self.max_pending and len(self._events) + b > self.max_pending:
                self._rejected += b
                raise ServerOverloaded(
                    f"batch wave of {b} + {len(self._events)} outstanding > "
                    f"max_pending={self.max_pending}")
            if self._feat_shape is None:
                check = getattr(self.captioner, "check_feat_shape", None)
                reason = check(item_shape) if check else None
                if reason is not None:
                    raise ValueError(reason)
                self._feat_shape = item_shape
            elif item_shape != self._feat_shape:
                raise ValueError(
                    f"feature shape {item_shape} != this server's "
                    f"{self._feat_shape}")
            for rid, ev in zip(rids, evs):
                self._events[rid] = ev
        t0 = time.monotonic()
        for rid, row in zip(rids, fb):
            self._queue.put((rid, row, opts) if opts else (rid, row))
        deadline = t0 + self.request_timeout_s
        for ev in evs:
            ev.wait(max(0.0, deadline - time.monotonic()))
        out = []
        with self._lock:
            for rid in rids:
                self._events.pop(rid, None)
                toks = self._tokens.pop(rid, None)
                done_at = self._done_at.pop(rid, None)
                if toks is None and not self._stopping.is_set():
                    self._cancelled.add(rid)
                elif toks is not None:
                    self._record_latency((done_at or time.monotonic()) - t0)
                out.append(toks)
        return out

    def _latency_quantiles(self):
        """(p50, p95) seconds over the recent-latency ring, or (None, None)."""
        with self._lock:
            lat = sorted(self._latencies)
        if not lat:
            return None, None
        return (lat[len(lat) // 2],
                lat[min(len(lat) - 1, int(len(lat) * 0.95))])

    def _prometheus_text(self) -> str:
        """Prometheus text exposition of the scheduler stats. Counter names
        mirror ContinuousCaptioner.stats keys; occupancy (useful token-steps
        per slot-step, the continuous-batching efficiency headline) and
        in-flight are gauges; request latency is a summary over submit() ->
        caption wall time."""
        return prometheus_text({"": self})

    def _metric_samples(self):
        """[(name, mtype, help, value), ...] for prometheus_text — one
        sample per metric for THIS server (latency summary handled there)."""
        c = self.captioner
        stats = dict(c.stats)
        occ = (stats["useful_steps"] / stats["slot_steps"]
               if stats["slot_steps"] else 0.0)
        return [
            ("vcr_requests_served_total", "counter",
             "Captions completed and harvested", stats["served"]),
            ("vcr_ticks_total", "counter",
             "Device tick calls (step_chunk micro-steps each)",
             stats["ticks"]),
            ("vcr_admit_chunks_total", "counter",
             "Fixed-shape admission chunks encoded", stats["admit_chunks"]),
            ("vcr_slot_steps_total", "counter",
             "Slot micro-steps executed (slots * step_chunk per tick)",
             stats["slot_steps"]),
            ("vcr_useful_steps_total", "counter",
             "Slot micro-steps that produced a kept token",
             stats["useful_steps"]),
            ("vcr_occupancy", "gauge",
             "useful_steps / slot_steps (continuous-batching efficiency)",
             f"{occ:.6f}"),
            ("vcr_requests_rejected_total", "counter",
             "Requests refused with 503 (max_pending back-pressure)",
             self._rejected),
            ("vcr_requests_cancelled_total", "counter",
             "Requests cancelled after client timeout (queued dropped "
             "or slot released)", stats.get("cancelled", 0)),
            ("vcr_in_flight", "gauge",
             "Requests currently occupying slots", c.in_flight),
            ("vcr_up", "gauge",
             "1 if the scheduler thread is healthy",
             0 if self.error else 1),
        ]

    def _requests(self):
        """Live request source for caption_stream: blocking wait while the
        pool is idle, non-blocking poll (None marker) while decodes are in
        flight — the tick loop never stalls on an empty queue."""
        while not self._stopping.is_set():
            self._profile_poll()
            timeout = 0.05 if self.captioner.in_flight == 0 else None
            try:
                if timeout is None:
                    yield self._queue.get_nowait()
                else:
                    yield self._queue.get(timeout=timeout)
            except queue.Empty:
                yield None

    def _capture_profile(self, seconds: float):
        """POST /profile: capture a torch.profiler trace of live serving for
        ``seconds``. torch.profiler records the operations of the thread
        that starts it (and every kernel on the card), so the capture job is
        handed to the scheduler thread, which starts and stops it between
        rounds (:meth:`_profile_poll`); this handler thread waits for it.
        Returns (http_code, payload). Disabled unless the server was built
        with profile_dir (a trace holds a handler thread and costs memory:
        operators opt in)."""
        if not self.profile_dir:
            return 403, {"error": "profiling disabled (start the server "
                                  "with profile_dir= / --serve_profile_dir)"}
        with self._lock:
            if self._profiling:
                return 409, {"error": "a profile capture is already running"}
            self._profiling = True
        try:
            out = os.path.join(self.profile_dir,
                               time.strftime("serve_trace_%Y%m%d_%H%M%S"))
            job = {"dir": out, "seconds": seconds, "done": threading.Event(),
                   "error": None}
            self._profile_jobs.put(job)
            if not job["done"].wait(seconds + 30.0):
                return 500, {"error": "the scheduler thread did not finish the "
                                      "capture"}
            if job["error"]:
                return 500, {"error": job["error"]}
            return 200, {"trace_dir": out, "seconds": seconds}
        finally:
            with self._lock:
                self._profiling = False

    def _profile_poll(self) -> None:
        """On the scheduler thread, between rounds: start a requested
        capture, or stop and write the running one once its time is up. A
        profiler failure is reported to the waiting handler, never raised
        into the scheduler."""
        job = self._profile_job
        try:
            if job is None:
                try:
                    job = self._profile_jobs.get_nowait()
                except queue.Empty:
                    return
                import torch
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                job["prof"] = profile(activities=acts)
                self._profile_job = job
                job["prof"].start()   # its first start takes a while
                job["spans"] = contextlib.ExitStack()
                job["rec"] = job["spans"].enter_context(profiling.recording())
                job["end"] = time.monotonic() + job["seconds"]
            elif time.monotonic() >= job["end"]:
                self._profile_job = None
                job["spans"].close()
                job["prof"].stop()
                os.makedirs(job["dir"], exist_ok=True)
                path = os.path.join(job["dir"], "trace.json")
                job["prof"].export_chrome_trace(path)
                profiling.add_spans_to_chrome_trace(path, job["rec"])
                job["done"].set()
        except Exception as e:  # a profiler failure must not kill serving
            self._profile_job = None
            if "spans" in job:
                job["spans"].close()
            job["error"] = repr(e)
            job["done"].set()

    def _poll_cancelled(self, outstanding):
        """run_slot_scheduler hook: the subset of the cancel set the
        scheduler can currently see. Rids not yet visible (still in the
        HTTP-side queue, not pulled into the scheduler's deque) STAY in the
        set for a later sweep; rids that complete anyway are removed at
        harvest (_scheduler) — every entry resolves one way or the other, so
        the set cannot leak."""
        self._profile_poll()
        with self._lock:
            gone = self._cancelled & outstanding
            self._cancelled -= gone
            return gone

    def _scheduler(self):
        try:
            for rid, toks in self.captioner.caption_stream(
                    self._requests(), poll_cancelled=self._poll_cancelled):
                with self._lock:
                    self._cancelled.discard(rid)  # completed before the sweep
                    ev = self._events.get(rid)
                    if ev is not None:  # dropped if the client timed out
                        self._tokens[rid] = toks
                        self._done_at[rid] = time.monotonic()
                        ev.set()
        except Exception as e:  # the daemon reports it (healthz, 504s)
            self.error = repr(e)
        finally:
            # crashed or shut down: release every waiting client (they see
            # None -> 504) instead of hanging until timeout, and end a
            # capture in flight
            self._stopping.set()
            with self._lock:
                for ev in self._events.values():
                    ev.set()
            jobs, self._profile_job = [self._profile_job], None
            while not self._profile_jobs.empty():
                jobs.append(self._profile_jobs.get_nowait())
            for job in filter(None, jobs):
                job["error"] = "the scheduler stopped during the capture"
                job["done"].set()
                if "prof" in job:
                    job["prof"].stop()

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "CaptionServer":
        self._sched.start()
        if self._http_thread is not None:
            self._http_thread.start()
        return self

    def close(self):
        self._stopping.set()
        if self._httpd is not None:
            self._httpd.shutdown()
        self._sched.join(timeout=30)
        if self._httpd is not None:
            self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
