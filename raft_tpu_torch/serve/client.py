"""Minimal stdlib client for the evaluation service (a copy of
``raft_tpu/serve/client.py``).

Used by load harnesses and the subprocess tests; keep-alive
``http.client`` connections so many synthetic clients stay cheap.  Not
a public SDK — the wire format is plain JSON over HTTP (see
:mod:`raft_tpu_torch.serve.http`).

Backpressure-aware retries: with ``retries=`` (default from
``RAFT_TPU_SERVE_CLIENT_RETRIES``, 0 = off) a 429/503 response is
retried after a capped exponential backoff that honors the server's
``Retry-After`` — :func:`backoff_delay` is the one schedule a client
and a router back off by.  Only CLEAN backpressure responses are
retried; a dropped response stays :class:`ResponseDropped` (re-sending
a possibly-accepted evaluate is the caller's call, never the
client's).
"""

from __future__ import annotations

import http.client
import json
import random
import time

from raft_tpu_torch.utils import config

#: responses the client-side retry loop may re-send: both are CLEAN
#: rejections (the request was never evaluated), so a re-send cannot
#: duplicate work
RETRYABLE_REJECTS = (429, 503)


def backoff_delay(attempt, base_s=0.05, cap_s=2.0, retry_after_s=None,
                  jitter=None):
    """Delay before retry number ``attempt`` (0-based): capped
    exponential ``min(cap_s, base_s * 2**attempt)``, overridden upward
    by an explicit server ``Retry-After`` (the server knows its drain/
    quota window better than any client-side curve), plus optional
    jitter — ``jitter()`` in [0, 1) scales the delay by up to +100% so
    a synchronized client herd de-synchronizes.  Deterministic when
    ``jitter`` is None (unit tests pin the schedule)."""
    d = min(float(cap_s), float(base_s) * (2.0 ** int(attempt)))
    if retry_after_s is not None:
        d = max(d, float(retry_after_s))
    if jitter is not None:
        d *= 1.0 + float(jitter())
    return d


class ResponseDropped(RuntimeError):
    """The request was (or may have been) delivered but the connection
    died before its response arrived.  Deliberately NOT a
    ``ConnectionError``: callers gating on "no accepted response was
    dropped" (a SIGTERM-drain check) must see this as a drop,
    never as a clean connection refusal — and the client must never
    silently re-send a non-idempotent evaluate for it."""


class ServeClient:
    """One keep-alive connection to a service instance."""

    def __init__(self, host, port, client_id=None, timeout=300.0,
                 retries=None, backoff_base_s=0.05, backoff_cap_s=2.0,
                 jitter=True, sleep=time.sleep):
        self.host, self.port = host, int(port)
        self.client_id = client_id
        self.timeout = timeout
        #: 429/503 retry budget (flag-gated: default
        #: RAFT_TPU_SERVE_CLIENT_RETRIES, 0 = return rejections as-is)
        self.retries = (int(config.get("SERVE_CLIENT_RETRIES"))
                        if retries is None else int(retries))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._jitter = random.random if jitter else None
        self._sleep = sleep
        self._conn = None
        #: response headers of the last completed round trip (the
        #: distributed-tracing tests read `traceparent` back from here)
        self.last_headers = {}
        #: parsed x-raft-provenance of the last response (None when the
        #: server sent no stamp): {bank_key, bank_sha, code, flags,
        #: replica} — WHAT produced the numbers, through the router too
        self.last_provenance = None

    def _connection(self):
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        return self._conn

    def close(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def request(self, method, path, payload=None, headers=None):
        """One logical request; returns ``(status_code, parsed_body)``
        — JSON-decoded when possible, raw text otherwise
        (``/metrics``).  With ``retries > 0``, clean 429/503
        rejections are re-sent after :func:`backoff_delay` (the
        server's ``Retry-After`` wins over the exponential curve)."""
        for attempt in range(self.retries + 1):
            status, body = self._round_trip(method, path, payload, headers)
            if status not in RETRYABLE_REJECTS or attempt >= self.retries:
                return status, body
            self._sleep(backoff_delay(
                attempt, self.backoff_base_s, self.backoff_cap_s,
                retry_after_s=self._retry_after(body),
                jitter=self._jitter))
        raise AssertionError("unreachable: retry loop always returns")

    def _retry_after(self, body):
        """The server's retry hint: the ``Retry-After`` header
        (integer seconds) or the payload's ``retry_after_s``."""
        ra = self.last_headers.get("retry-after")
        if ra is not None and str(ra).strip().isdigit():
            return float(ra)
        if isinstance(body, dict) and body.get("retry_after_s") is not None:
            try:
                return float(body["retry_after_s"])
            except (TypeError, ValueError):
                return None
        return None

    def _round_trip(self, method, path, payload=None, headers=None):
        """One wire round trip (no retry policy)."""
        body = None
        headers = dict(headers or {})
        if payload is not None:
            body = json.dumps(payload)
            headers["Content-Type"] = "application/json"
        if self.client_id:
            headers["X-Client"] = str(self.client_id)
        conn = self._connection()
        try:
            conn.request(method, path, body=body, headers=headers)
        except (http.client.HTTPException, ConnectionError, OSError):
            # SEND failed — the server never processed the request, so
            # one fresh-connection retry is safe even for POST (covers
            # the stale-keep-alive race)
            self.close()
            conn = self._connection()
            conn.request(method, path, body=body, headers=headers)
        try:
            resp = conn.getresponse()
            data = resp.read()
        except (http.client.HTTPException, ConnectionError, OSError) as e:
            # the request may have been ACCEPTED: re-sending would
            # duplicate a non-idempotent evaluation (and eat a second
            # quota token), and calling this a refusal would hide a
            # dropped response from the drain gate
            self.close()
            raise ResponseDropped(
                f"connection lost awaiting {method} {path}: {e!r}") from e
        self.last_headers = {k.lower(): v for k, v in resp.getheaders()}
        from raft_tpu_torch.obs.alerts import parse_provenance

        self.last_provenance = parse_provenance(
            self.last_headers.get("x-raft-provenance"))
        if resp.will_close:
            self.close()
        try:
            return resp.status, json.loads(data)
        except ValueError:
            return resp.status, data.decode(errors="replace")

    def evaluate(self, design, Hs, Tp, beta, out_keys=None,
                 escalate_f64=False, traceparent=None):
        payload = {"design": design, "Hs": Hs, "Tp": Tp, "beta": beta}
        if out_keys:
            payload["out_keys"] = list(out_keys)
        if escalate_f64:
            payload["escalate_f64"] = True
        headers = {"traceparent": traceparent} if traceparent else None
        return self.request("POST", "/evaluate", payload, headers=headers)

    def healthz(self):
        return self.request("GET", "/healthz")

    def metrics_text(self):
        return self.request("GET", "/metrics")
