"""Serving front door: an async streaming gateway over the continuous
engine.

- :mod:`repro_torch.serve.gateway.protocol`: the typed wire schema,
  request fields, validation and the ndjson stream events.
- :mod:`repro_torch.serve.gateway.server`: the asyncio front door.
  ``EngineBridge`` runs the engine's tick loop in a background thread
  with a thread-safe submission queue and per-request async token
  channels; ``Gateway`` speaks minimal HTTP/1.1 on top (``POST
  /generate`` streaming, ``GET /metrics``, ``GET /healthz``).
- :mod:`repro_torch.serve.gateway.placement`: pool sizing from a bundle:
  a worker reads the bundle's ``report.json`` and ``config.json`` (never
  the weights) to size its slot and block pools for a memory budget.
"""
from repro_torch.serve.gateway.placement import Placement, plan_placement
from repro_torch.serve.gateway.protocol import (GenerateRequest,
                                                ProtocolError,
                                                parse_request)
from repro_torch.serve.gateway.server import EngineBridge, Gateway

__all__ = ["GenerateRequest", "ProtocolError", "parse_request",
           "EngineBridge", "Gateway", "Placement", "plan_placement"]
