"""Client for the caption-serving daemon (``vcr_tpu_torch/server.py`` and
``multiserver.py``): the counterpart of ``vcr_tpu/client.py``, which talks
to either package's daemon (the wire format is the same).

Numpy and the stdlib's urllib only, so it ships to machines that have
neither PyTorch nor this package (raw .npy bytes in, JSON out: see
server.py's API docstring).

Usage:
    from vcr_tpu_torch.client import CaptionClient

    client = CaptionClient("http://10.0.0.5:8000")
    tokens, caption = client.caption(feats)           # (N, Dv) float32
    results = client.caption_many([f0, f1, f2])       # concurrent POSTs
    print(client.health()["latency_p50_ms"])
"""

from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np


class CaptionServerError(RuntimeError):
    """The server answered with an error status (carries ``.code``)."""

    def __init__(self, code: int, message: str):
        super().__init__(f"HTTP {code}: {message}")
        self.code = code


class CaptionClient:
    """Talks to a running CaptionServer.

    Args:
      base_url: e.g. ``"http://127.0.0.1:8000"`` (no trailing slash needed).
      timeout_s: per-request socket timeout. Must exceed the server's
        queue+decode latency under load; the server's own
        ``request_timeout_s`` bounds the wait on its side (504).
      retries: connection-level retries (server not yet up, transient socket
        errors). HTTP error *responses* are never retried except 504 —
        a 400 will not become a 200 by retrying, but a timed-out caption
        may simply need a quieter moment.
      backoff_s: initial retry sleep, doubled per attempt.
    """

    def __init__(self, base_url: str, *, timeout_s: float = 120.0,
                 retries: int = 3, backoff_s: float = 0.2,
                 model: Optional[str] = None, token: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s
        # bearer token for servers started with --serve_auth_token
        self.token = token
        # against a MULTI-model daemon (MultiCaptionServer), name the model
        # to talk to: caption routes become /caption/<model>. None = the
        # single-model daemon's routes.
        self.model = model

    # ------------------------------------------------------------- plumbing

    def _request(self, path: str, data: Optional[bytes] = None,
                 raw: bool = False, timeout_s: Optional[float] = None,
                 retries: Optional[int] = None):
        url = self.base_url + path
        delay = self.backoff_s
        retries = self.retries if retries is None else retries
        last: Exception = RuntimeError("unreachable")
        for attempt in range(retries + 1):
            headers = ({"Content-Type": "application/octet-stream"}
                       if data is not None else {})
            if self.token:
                headers["Authorization"] = f"Bearer {self.token}"
            req = urllib.request.Request(url, data=data, headers=headers)
            try:
                with urllib.request.urlopen(
                        req, timeout=timeout_s or self.timeout_s) as r:
                    body = r.read()
                    return body.decode() if raw else json.loads(body)
            except urllib.error.HTTPError as e:
                msg = e.read().decode(errors="replace")
                try:
                    msg = json.loads(msg).get("error", msg)
                except (json.JSONDecodeError, ValueError, AttributeError):
                    pass
                # 503 (back-pressure, sent with Retry-After) and 504 (this
                # caption timed out) are transient — a retry can succeed;
                # 4xx never will
                if e.code not in (503, 504) or attempt == retries:
                    raise CaptionServerError(e.code, msg) from None
                last = CaptionServerError(e.code, msg)
                if e.code == 503:
                    try:
                        delay = max(delay,
                                    float(e.headers.get("Retry-After", 0)))
                    except (TypeError, ValueError):
                        pass
            except (urllib.error.URLError, ConnectionError, TimeoutError,
                    OSError) as e:
                if attempt == retries:
                    raise
                last = e
            time.sleep(delay)
            delay *= 2
        raise last  # pragma: no cover - loop always raises or returns

    # ------------------------------------------------------------------ API

    def caption(self, feats: np.ndarray) -> Tuple[List[int], Optional[str]]:
        """POST one video's features; returns (tokens, caption-or-None).
        ``feats``: (num_frames, feat_dim) float32 (or whatever fixed shape
        the server's model expects — spatial models take (N, F, K, K))."""
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(np.asarray(feats, np.float32)))
        out = self._request(self._route("/caption"), data=buf.getvalue())
        return [int(t) for t in out["tokens"]], out.get("caption")

    def _route(self, path: str) -> str:
        return f"{path}/{self.model}" if self.model else path

    def models(self) -> dict:
        """GET /models (multi-model daemons): {name: {arch, slots, ...}}."""
        return self._request("/models")["models"]

    def caption_batch(self, feats_batch: np.ndarray,
                      timeout_s: Optional[float] = None
                      ) -> List[Optional[Tuple[List[int], Optional[str]]]]:
        """POST /caption_batch: one request carries a whole (B, ...) feature
        batch; returns a length-B list of (tokens, caption-or-None) in input
        order, with None for rows the server timed out. One connection and
        one .npy payload instead of B concurrent POSTs — the bulk path for
        offline corpora; for live traffic prefer caption_many (per-request
        latency accounting, per-row retries).

        The server drains batches larger than its max_pending in sequential
        WAVES, each taking up to its own request_timeout_s, and sends no
        bytes until the whole batch is done — so the socket timeout here
        defaults to ``timeout_s_per_row * B`` headroom (0.5s/row, floored at
        the client timeout) rather than the plain per-request timeout, and
        the request is NEVER blind-retried on a socket timeout (the server
        is still decoding the originals; re-POSTing would multiply device
        work). Pass ``timeout_s`` to override."""
        fb = np.ascontiguousarray(np.asarray(feats_batch, np.float32))
        buf = io.BytesIO()
        np.save(buf, fb)
        if timeout_s is None:
            timeout_s = max(self.timeout_s, 0.5 * len(fb))
        out = self._request(self._route("/caption_batch"),
                            data=buf.getvalue(), timeout_s=timeout_s,
                            retries=0)
        return [None if row is None
                else ([int(t) for t in row["tokens"]], row.get("caption"))
                for row in out["results"]]

    def caption_many(self, feats_list: Sequence[np.ndarray],
                     max_workers: int = 16
                     ) -> List[Tuple[List[int], Optional[str]]]:
        """Concurrent POSTs — the server's continuous batcher multiplexes
        them onto one slot pool, so concurrency IS the batching knob."""
        workers = max(1, min(max_workers, len(feats_list)))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(self.caption, feats_list))

    def health(self) -> dict:
        """GET /healthz: scheduler stats + latency percentiles."""
        return self._request("/healthz")

    def metrics(self) -> str:
        """GET /metrics: Prometheus text exposition (scrape-ready)."""
        return self._request("/metrics", raw=True)

    def wait_ready(self, timeout_s: float = 60.0) -> dict:
        """Poll /healthz until the server answers (e.g. right after spawning
        ``--mode serve`` as a subprocess). Returns the first health payload."""
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                return self.health()
            except Exception:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
