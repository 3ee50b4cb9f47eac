"""Length-prefixed JSON wire protocol (a copy of ``gym_tpu/serve/wire.py``
after this docstring, pinned to it by ``tests/test_torch_serve_http.py``).

The out-of-process fleet's worker and router speak it over a local stream
socket; in the port it rides with the in-process router, and the process
fleet that carries frames over it is ROADMAP item 15. Its contract:

- **Typed failure, never a hang.** Every malformed input — truncated
  stream, oversized length prefix, non-JSON payload, unknown frame
  type — raises a ``WireError`` subclass; the length prefix is validated
  before the payload is read.
- **Self-describing frames.** Every frame is a JSON object with a
  ``type`` drawn from ``FRAME_TYPES``; request-scoped frames carry the
  router-assigned ``id``.
- **stdlib only.** No torch, no serving internals at import.
- **Content integrity.** Every outgoing frame carries a ``crc`` field,
  zlib crc32 of the frame's canonical JSON (sorted keys, ``crc``
  excluded); ``decode_payload`` verifies it and raises
  ``FrameCorruptError`` on a mismatch. Frames without ``crc`` are
  accepted unverified. ``encode_frame`` is the ``wire.frame`` corruption
  fault site (``corrupt_point``).
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Any, Callable, Dict, Optional

from ..utils.resilience import corrupt_point

#: Hard cap on one frame's JSON payload. Generous for token streams
#: (a 1M-token chunk is ~8 MB of JSON) yet small enough that a corrupt
#: length prefix cannot demand an absurd allocation.
MAX_FRAME_BYTES = 16 << 20

_LEN = struct.Struct(">I")

FRAME_TYPES = frozenset({
    "submit", "accepted", "chunk", "done", "error", "cancel",
    "health", "health_ok", "stats", "stats_ok",
    "reload", "reload_ok", "stop", "stop_ok", "hello",
})


class WireError(RuntimeError):
    """Base class for every protocol violation — callers that just need
    "this peer is speaking garbage" catch this one."""


class FrameTooLargeError(WireError):
    """The length prefix (or an outgoing payload) exceeds
    ``MAX_FRAME_BYTES`` — rejected before any payload is read/sent."""


class TruncatedFrameError(WireError):
    """The stream ended mid-frame (inside the length prefix or the
    payload): the peer died or the transport corrupted. Distinct from a
    CLEAN close, which ``read_frame`` reports as ``None``."""


class MalformedFrameError(WireError):
    """The payload is not a JSON object with a known ``type`` — the
    frame is syntactically present but semantically garbage."""


class FrameCorruptError(WireError):
    """The frame's ``crc`` disagrees with its content — the bytes were
    silently corrupted in transit (or by an injected ``wire.frame``
    fault). A ``WireError`` subclass on purpose: the router's reader
    loop already maps any ``WireError`` to mark-dead + failover, which
    is exactly the right response to a peer whose bytes can't be
    trusted."""


def _frame_crc(frame: Dict[str, Any]) -> int:
    """crc32 over the frame's CANONICAL encoding (sorted keys, compact
    separators, ``crc`` excluded). Canonicalizing makes the checksum
    independent of key order and of the sender's ``json.dumps``
    settings — both ends must agree on the bytes being summed, and a
    decoded dict no longer remembers the wire bytes it came from.

    zlib's C crc32 rather than the sidecars' pure-Python crc32c: this
    runs per frame on the token streaming hot path, where the Python
    table walk (~12 µs/frame, measured) cost the subprocess fleet its
    throughput edge over the thread fleet. Checkpoint sidecars keep
    crc32c — they hash megabytes once per save, not bytes per token."""
    body = {k: v for k, v in frame.items() if k != "crc"}
    return zlib.crc32(json.dumps(
        body, sort_keys=True, separators=(",", ":")).encode())


# Wire layout of a checksummed frame: the canonical body dump with
# ',"crc":"xxxxxxxx"}' spliced over the closing brace. Emitting the
# EXACT bytes the crc was computed over lets decode verify against the
# raw payload (one zlib.crc32 call, no re-serialization); the canonical
# re-encode in _frame_crc is only the fallback for foreign encoders.
_CRC_SUFFIX_LEN = len(',"crc":"00000000"}')


def encode_frame(frame: Dict[str, Any]) -> bytes:
    """``frame`` → ``>I``-length-prefixed UTF-8 JSON bytes. Validates
    the same invariants ``read_frame`` enforces so a bad frame fails on
    the SENDING side, where the stack trace names the bug."""
    if not isinstance(frame, dict):
        raise MalformedFrameError(
            f"frame must be a dict, got {type(frame).__name__}")
    ftype = frame.get("type")
    if ftype not in FRAME_TYPES:
        raise MalformedFrameError(
            f"unknown frame type {ftype!r} (known: "
            f"{sorted(FRAME_TYPES)})")
    try:
        if "crc" in frame:  # never double-stamp a re-encoded frame
            frame = {k: v for k, v in frame.items() if k != "crc"}
        canon = json.dumps(frame, sort_keys=True, separators=(",", ":"))
        payload = (
            f'{canon[:-1]},"crc":"{zlib.crc32(canon.encode()):08x}"}}'
            if canon != "{}" else "{}").encode()
    except (TypeError, ValueError) as e:
        raise MalformedFrameError(
            f"frame is not JSON-serializable: {e}") from e
    if len(payload) > MAX_FRAME_BYTES:
        raise FrameTooLargeError(
            f"frame payload {len(payload)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte cap")
    # The wire.frame corruption site operates on the PAYLOAD, before the
    # length prefix is computed: framing stays intact, so an injected
    # bitflip/truncation must be caught by the CONTENT layer (crc or
    # JSON parse) — the detector under test — not by accidental
    # misframing. Misframed/truncated streams have their own typed
    # coverage (TruncatedFrameError / FrameTooLargeError).
    payload = corrupt_point("wire.frame", payload)
    return _LEN.pack(len(payload)) + payload


def decode_payload(payload: bytes) -> Dict[str, Any]:
    """Validate + parse one frame payload (the bytes AFTER the length
    prefix). The single point both the blocking and the async readers
    funnel through."""
    # Fast verify on the RAW bytes: our encoder emits exactly the
    # canonical body with the crc suffix spliced over the closing
    # brace, so checksumming payload-minus-suffix reproduces the
    # stamped value without parsing or re-serializing anything. Any
    # corruption — body, suffix, or the crc digits themselves — makes
    # this miss, and we fall through to the canonical-recompute path
    # (which also verifies frames from foreign encoders that place the
    # field elsewhere).
    fast_verified = False
    if len(payload) > _CRC_SUFFIX_LEN and payload.endswith(b'"}') \
            and payload[-_CRC_SUFFIX_LEN:-10] == b',"crc":"':
        body_bytes = payload[: -_CRC_SUFFIX_LEN] + b"}"
        fast_verified = (
            payload[-10:-2] == b"%08x" % zlib.crc32(body_bytes))
        if fast_verified:
            payload = body_bytes
    try:
        frame = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise MalformedFrameError(f"frame payload is not JSON: {e}") from e
    if not isinstance(frame, dict):
        raise MalformedFrameError(
            f"frame must decode to an object, got "
            f"{type(frame).__name__}")
    crc = frame.pop("crc", None)
    if crc is not None and not fast_verified:
        # Verify-and-strip: downstream handlers never see the field, so
        # strict field validators (the worker's submit whitelist) need
        # no knowledge of it. A crc-less frame is an OLD-format peer —
        # accepted unverified (mixed-fleet soft-degrade).
        want = f"{_frame_crc(frame):08x}"
        if crc != want:
            raise FrameCorruptError(
                f"frame crc mismatch: carried {crc!r}, content hashes "
                f"to {want!r} — bytes corrupted in transit "
                f"(type={frame.get('type')!r}, id={frame.get('id')!r})")
    if frame.get("type") not in FRAME_TYPES:
        raise MalformedFrameError(
            f"unknown frame type {frame.get('type')!r}")
    return frame


def read_frame(recv: Callable[[int], bytes]) -> Optional[Dict[str, Any]]:
    """Read one frame via ``recv(n) -> bytes`` (a ``socket.recv``-shaped
    callable: returns at MOST n bytes, b'' on EOF). Returns the decoded
    frame, or ``None`` on a clean EOF at a frame boundary. Raises
    ``TruncatedFrameError`` on EOF mid-frame, ``FrameTooLargeError``
    before reading an oversized payload, ``MalformedFrameError`` on
    garbage — typed, never a hang, never a partial-read corruption
    (either a whole frame is returned or the stream is declared bad)."""
    header = _read_exact(recv, _LEN.size, allow_clean_eof=True)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise FrameTooLargeError(
            f"frame length prefix {length} exceeds the "
            f"{MAX_FRAME_BYTES}-byte cap — refusing to read the payload")
    payload = _read_exact(recv, length, allow_clean_eof=False)
    return decode_payload(payload)


def _read_exact(recv: Callable[[int], bytes], n: int,
                allow_clean_eof: bool) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = recv(n - len(buf))
        if not chunk:
            if allow_clean_eof and not buf:
                return None
            raise TruncatedFrameError(
                f"stream ended after {len(buf)} of {n} expected bytes")
        buf.extend(chunk)
    return bytes(buf)


async def read_frame_async(reader) -> Dict[str, Any]:
    """One frame from an ``asyncio.StreamReader`` — the async twin of
    ``read_frame``, sharing the same length-prefix validation and
    ``decode_payload`` so the framing invariants live in ONE place.
    Raises ``asyncio.IncompleteReadError`` on EOF (the async reader's
    native truncation signal) and the same typed ``WireError``
    subclasses otherwise."""
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise FrameTooLargeError(
            f"frame length prefix {length} exceeds the "
            f"{MAX_FRAME_BYTES}-byte cap — refusing to read the payload")
    payload = await reader.readexactly(length)
    return decode_payload(payload)


def send_frame(sock: socket.socket, frame: Dict[str, Any]) -> None:
    """Blocking send of one whole frame (``sendall`` — no partial
    writes survive)."""
    sock.sendall(encode_frame(frame))


def recv_frame(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """Blocking read of one whole frame from a socket (see
    ``read_frame`` for the error contract)."""
    return read_frame(sock.recv)


# -- typed exceptions over the wire ---------------------------------------

#: Exception class names a worker may legitimately report. The router
#: reconstructs these TYPED (same class, same message) so the HTTP
#: status mapping — 429/503/504, Retry-After — is identical whether the
#: failure happened in-process or across the socket. Import is deferred
#: so wire.py stays jax-free for the codec unit tests.
_SCHEDULER_ERRORS = (
    "AdmissionRejectedError", "QuotaExceededError", "QueueFullError",
    "DeadlineExceededError", "EngineFailedError", "SlotQuarantinedError",
    "SchedulerClosedError", "RequestCancelledError",
    "RequestFailedError",
)


def exception_to_frame(req_id: Any, exc: BaseException) -> Dict[str, Any]:
    """Serialize a request failure as an ``error`` frame, preserving the
    class name and the admission-control ``retry_after_s`` hint."""
    frame: Dict[str, Any] = {
        "type": "error", "id": req_id,
        "error_type": type(exc).__name__, "message": str(exc),
    }
    retry = getattr(exc, "retry_after_s", None)
    if retry is not None:
        frame["retry_after_s"] = float(retry)
    return frame


def frame_to_exception(frame: Dict[str, Any]) -> BaseException:
    """Reconstruct the typed exception an ``error`` frame carries.
    Unknown/unmappable types degrade to ``EngineFailedError`` (retry is
    safe: the worker-side request died with its engine state) rather
    than losing the failure or inventing an untyped RuntimeError."""
    name = frame.get("error_type")
    msg = str(frame.get("message", "worker reported an error"))
    if name == "ValueError":
        return ValueError(msg)
    if name in _SCHEDULER_ERRORS:
        from . import scheduler as _sched
        cls = getattr(_sched, name, None)
        if cls is not None:
            if name in ("AdmissionRejectedError", "QuotaExceededError"):
                # both take (msg, retry_after_s) — the Retry-After hint
                # must survive the socket hop so the router's
                # cheapest-reject ladder and the HTTP 429 stay exact
                return cls(msg, retry_after_s=float(
                    frame.get("retry_after_s", 1.0)))
            return cls(msg)
    from .scheduler import EngineFailedError
    return EngineFailedError(f"{name}: {msg}")


def sampling_to_dict(sp: Any) -> Dict[str, Any]:
    """``SamplingParams`` → JSON-safe dict (dataclass-agnostic so wire
    stays import-light)."""
    return {
        "max_new_tokens": int(sp.max_new_tokens),
        "temperature": float(sp.temperature),
        "top_k": None if sp.top_k is None else int(sp.top_k),
        "top_p": None if sp.top_p is None else float(sp.top_p),
        "eos_token": None if sp.eos_token is None else int(sp.eos_token),
        "seed": int(sp.seed),
    }


def sampling_from_dict(d: Dict[str, Any]):
    from .engine import SamplingParams
    return SamplingParams(
        max_new_tokens=int(d.get("max_new_tokens", 32)),
        temperature=float(d.get("temperature", 1.0)),
        top_k=None if d.get("top_k") is None else int(d["top_k"]),
        top_p=None if d.get("top_p") is None else float(d["top_p"]),
        eos_token=(None if d.get("eos_token") is None
                   else int(d["eos_token"])),
        seed=int(d.get("seed", 0)))
