"""Gateway wire schema: typed request/response + ndjson stream events.

A generation request is one JSON object (the body of ``POST
/generate``). Either ``prompt`` (text, encoded by the placeholder
byte-level tokenizer — the repo has no learned tokenizer) or ``tokens``
(explicit token ids) must be present, never both. Everything else is
optional with engine defaults; ``priority`` and ``deadline_ms`` only
matter under the ``priority`` / ``slo`` scheduler policies.

The response is a newline-delimited JSON event stream (one object per
line, ``Content-Type: application/x-ndjson``):

- ``{"event": "token", "uid", "index", "token"}`` — one generated
  token, in order (tokens surface at decode-burst boundaries, so
  several lines may arrive at once).
- ``{"event": "done", "uid", "tokens", "finish_reason", "metrics"}`` —
  terminal; ``metrics`` carries the request's per-stage latencies
  (``queue_ms`` / ``prefill_ms`` / ``decode_ms`` / ``total_ms``).
- ``{"event": "rejected", "uid", "reason"}`` — terminal; ``reason`` is
  the scheduler's structured rejection reason
  (``prompt_too_long`` | ``insufficient_blocks``).
- ``{"event": "error", "error"}`` — malformed request (HTTP 400).

With ``"stream": false`` the gateway buffers and returns only the
terminal event as a plain JSON response. Parsing failures raise
:class:`ProtocolError` (mapped to HTTP 400 with an ``error`` event).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serve.metrics import stage_latencies_ms
from repro_torch.serve.scheduler import Finished, Rejection, Request


class ProtocolError(ValueError):
    """Malformed gateway request (maps to HTTP 400)."""


@dataclasses.dataclass(frozen=True)
class GenerateRequest:
    """The ``POST /generate`` body, validated."""
    prompt: Optional[str] = None        # text (placeholder byte tokenizer)
    tokens: Optional[tuple] = None      # explicit token ids
    max_new_tokens: int = 16
    temperature: Optional[float] = None  # None = engine default
    seed: Optional[int] = None           # None = engine-run stream
    priority: int = 0                    # higher = sooner ("priority")
    prefix_id: Optional[str] = None      # paged prefix-sharing identity
    deadline_ms: Optional[float] = None  # latency SLO ("slo" policy)
    eos_id: Optional[int] = None         # stop token
    stream: bool = True                  # ndjson stream vs buffered JSON


# the wire fields, in schema order (docs-sync test anchors on this)
REQUEST_FIELDS = tuple(f.name for f in dataclasses.fields(GenerateRequest))


def encode_text(prompt: str, vocab: int) -> list:
    """Placeholder byte-level tokenizer: UTF-8 bytes folded into the
    model's vocab. Deterministic and reversible enough for smoke
    traffic; swap in a real tokenizer for a real deployment."""
    return [b % vocab for b in prompt.encode("utf-8")]


def parse_request(body: dict, vocab: int) -> GenerateRequest:
    """Validate one JSON body into a :class:`GenerateRequest`."""
    if not isinstance(body, dict):
        raise ProtocolError("request body must be a JSON object")
    unknown = set(body) - set(REQUEST_FIELDS)
    if unknown:
        raise ProtocolError(f"unknown fields: {sorted(unknown)}")
    prompt = body.get("prompt")
    tokens = body.get("tokens")
    if (prompt is None) == (tokens is None):
        raise ProtocolError("exactly one of 'prompt' (text) or "
                            "'tokens' (ids) is required")
    if prompt is not None and not isinstance(prompt, str):
        raise ProtocolError("'prompt' must be a string")
    if tokens is not None:
        if (not isinstance(tokens, list) or not tokens
                or not all(isinstance(t, int) for t in tokens)):
            raise ProtocolError("'tokens' must be a non-empty list of ints")
        if not all(0 <= t < vocab for t in tokens):
            raise ProtocolError(f"token ids must be in [0, {vocab})")
        tokens = tuple(tokens)
    max_new = body.get("max_new_tokens", 16)
    if not isinstance(max_new, int) or max_new < 1:
        raise ProtocolError("'max_new_tokens' must be a positive int")
    for name, typ in (("temperature", (int, float)), ("seed", int),
                      ("priority", int), ("deadline_ms", (int, float)),
                      ("eos_id", int), ("prefix_id", str)):
        val = body.get(name)
        if val is not None and not isinstance(val, typ):
            raise ProtocolError(f"'{name}' must be {typ}")
    if body.get("deadline_ms") is not None and body["deadline_ms"] <= 0:
        raise ProtocolError("'deadline_ms' must be positive")
    return GenerateRequest(
        prompt=prompt, tokens=tokens, max_new_tokens=max_new,
        temperature=body.get("temperature"), seed=body.get("seed"),
        priority=body.get("priority", 0),
        prefix_id=body.get("prefix_id"),
        deadline_ms=body.get("deadline_ms"),
        eos_id=body.get("eos_id"),
        stream=bool(body.get("stream", True)))


def to_engine_request(greq: GenerateRequest, uid: int,
                      vocab: int) -> Request:
    """Bind a validated wire request to an engine scheduler Request.
    ``arrival`` is stamped by the engine feed at intake."""
    toks = (list(greq.tokens) if greq.tokens is not None
            else encode_text(greq.prompt, vocab))
    if not toks:
        raise ProtocolError("'prompt' encoded to zero tokens")
    return Request(
        uid=uid, prompt=toks, max_new_tokens=greq.max_new_tokens,
        eos_id=greq.eos_id, prefix_id=greq.prefix_id,
        temperature=greq.temperature, seed=greq.seed,
        priority=greq.priority, deadline_ms=greq.deadline_ms)


# ------------------------------------------------------------- events

def token_event(uid: int, index: int, token: int) -> dict:
    return {"event": "token", "uid": uid, "index": index, "token": token}


def done_event(fin: Finished) -> dict:
    return {"event": "done", "uid": fin.request.uid,
            "tokens": list(fin.tokens), "finish_reason": fin.reason,
            "prompt_blocks_shared": fin.prompt_blocks_shared,
            "metrics": {k: round(v, 3)
                        for k, v in stage_latencies_ms(fin).items()}}


def rejected_event(rej: Rejection) -> dict:
    return {"event": "rejected", "uid": rej.request.uid,
            "reason": rej.reason}


def error_event(message: str, uid: Optional[int] = None) -> dict:
    ev = {"event": "error", "error": message}
    if uid is not None:
        ev["uid"] = uid
    return ev
