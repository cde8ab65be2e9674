"""Shared HTTP/1.1 wire helpers for the serving stack (a copy of
``raft_tpu/serve/wire.py``; stdlib only).

One deliberately small HTTP implementation: :mod:`raft_tpu_torch.serve.
http` parses requests and formats responses with it, and
:func:`proxy_request` is the asyncio upstream client of the fleet
router (:mod:`raft_tpu_torch.serve.router`).  It imports no torch, so a
network process built on it starts while the card is busy.
"""

from __future__ import annotations

import asyncio
import json

STATUS_TEXT = {200: "OK", 202: "Accepted", 400: "Bad Request",
               403: "Forbidden", 404: "Not Found",
               405: "Method Not Allowed", 408: "Request Timeout",
               413: "Payload Too Large", 422: "Unprocessable Entity",
               429: "Too Many Requests", 500: "Internal Server Error",
               502: "Bad Gateway", 503: "Service Unavailable"}

MAX_BODY_BYTES = 8 * 1024 * 1024

#: peer hosts the admin endpoints (``POST /drain``) accept — drain is
#: an operator/router verb, never a tenant one
LOOPBACK_HOSTS = ("127.0.0.1", "::1", "localhost")


async def read_request(reader):
    """One HTTP request off the stream: ``(method, path, headers,
    body)``, or None on clean EOF."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1").strip().split()
    if len(parts) < 2:
        raise ValueError(f"bad request line {line!r}")
    method, path = parts[0].upper(), parts[1].split("?", 1)[0]
    headers = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    n = int(headers.get("content-length", 0) or 0)
    if n > MAX_BODY_BYTES:
        raise ValueError(f"body of {n} bytes exceeds {MAX_BODY_BYTES}")
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body


def response_bytes(status, payload, keep_alive, extra_headers=None):
    """Serialize one response: dict/list payloads as JSON, anything
    else as plain text (``/metrics``)."""
    if isinstance(payload, (dict, list)):
        data = json.dumps(payload).encode()
        ctype = "application/json"
    else:
        data = str(payload).encode()
        ctype = "text/plain; version=0.0.4"
    head = [f"HTTP/1.1 {status} {STATUS_TEXT.get(status, 'Unknown')}",
            f"Content-Type: {ctype}",
            f"Content-Length: {len(data)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    for name, value in (extra_headers or {}).items():
        head.append(f"{name}: {value}")
    if status in (429, 503) and isinstance(payload, dict) \
            and "retry-after" not in {k.lower()
                                      for k in (extra_headers or {})}:
        head.append(
            f"Retry-After: {max(1, int(payload.get('retry_after_s') or 0) + 1)}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + data


class UpstreamError(RuntimeError):
    """A proxied request failed before a complete response arrived
    (connect refused/reset, short read, per-attempt timeout).  The
    router's failover ladder treats this as retryable: serving
    evaluations are idempotent by construction (content-addressed
    result/program caches make duplicate dispatch benign — the same
    argument that makes fabric double-compute safe)."""

    def __init__(self, reason, detail=""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


async def proxy_request(host, port, method, path, body=b"",
                        headers=None, timeout_s=30.0):
    """One upstream round trip (fresh connection, ``Connection:
    close``): returns ``(status, headers, body_bytes)`` or raises
    :class:`UpstreamError`.  Pure asyncio — the router calls this on
    its event loop; no thread, no http.client."""
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout=timeout_s)
    except (OSError, asyncio.TimeoutError) as e:
        raise UpstreamError("connect", repr(e)) from e
    try:
        head = [f"{method} {path} HTTP/1.1",
                f"Host: {host}:{port}",
                "Connection: close",
                f"Content-Length: {len(body)}"]
        for name, value in (headers or {}).items():
            if name.lower() in ("host", "connection", "content-length"):
                continue
            head.append(f"{name}: {value}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await asyncio.wait_for(writer.drain(), timeout=timeout_s)

        async def _read_response():
            line = await reader.readline()
            if not line:
                raise UpstreamError("closed", "no status line")
            parts = line.decode("latin-1").split()
            if len(parts) < 2 or not parts[1].isdigit():
                raise UpstreamError("protocol", f"bad status line {line!r}")
            status = int(parts[1])
            resp_headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                name, _, value = h.decode("latin-1").partition(":")
                resp_headers[name.strip().lower()] = value.strip()
            n = int(resp_headers.get("content-length", 0) or 0)
            data = await reader.readexactly(n) if n else await reader.read()
            return status, resp_headers, data

        return await asyncio.wait_for(_read_response(), timeout=timeout_s)
    except UpstreamError:
        raise
    except asyncio.TimeoutError as e:
        raise UpstreamError("timeout",
                            f"{method} {path} after {timeout_s}s") from e
    except (OSError, asyncio.IncompleteReadError, ValueError) as e:
        raise UpstreamError("dropped", repr(e)) from e
    finally:
        try:
            writer.close()
        except Exception:  # noqa: BLE001 — best-effort close
            pass
