"""Asyncio front door over the continuous engine.

Two layers:

- :class:`EngineBridge` runs ``ContinuousEngine.serve_forever`` in a
  background thread and marshals its events back onto the asyncio
  loop. Submissions go through a thread-safe ``queue.Queue``; each
  request gets its own ``asyncio.Queue`` token channel, fed via
  ``loop.call_soon_threadsafe`` so the engine thread never touches
  asyncio state directly. Because the bridge drives the same tick loop
  as ``ContinuousEngine.run`` (the feed seam in
  ``repro_torch.serve.batching``), streamed outputs are token-identical
  to driving the engine directly.
- :class:`Gateway` speaks minimal HTTP/1.1 on ``asyncio.start_server``
  (no web framework): ``POST /generate`` streams ndjson events (see
  :mod:`repro_torch.serve.gateway.protocol`), ``GET /metrics`` dumps the
  engine's :class:`~repro_torch.serve.metrics.MetricsRegistry` summary
  plus live request counters, ``GET /healthz`` reports engine-thread
  liveness. Responses are close-delimited (``Connection: close``).

``port=0`` binds an ephemeral port (tests); ``Gateway.port`` reports
the bound port after ``start()``.
"""
from __future__ import annotations

import asyncio
import itertools
import json
import queue as queue_mod
import threading
from typing import Optional

from repro_torch.serve.gateway import protocol as P
from repro_torch.serve.gateway.protocol import (GenerateRequest,
                                                ProtocolError,
                                                parse_request)


class EngineBridge:
    """Owns the engine thread and the per-request async token channels.

    All public methods must be called from the asyncio event-loop
    thread (the channels dict is loop-confined); only ``_emit`` runs on
    the engine thread, and it crosses back via
    ``call_soon_threadsafe``.
    """

    def __init__(self, engine, temperature: float = 0.0, seed: int = 0,
                 max_burst: int = 8, poll_s: float = 0.002):
        self.engine = engine
        self.temperature = temperature
        self.seed = seed
        self.max_burst = max_burst
        self.poll_s = poll_s
        self.inbox: queue_mod.Queue = queue_mod.Queue()
        self.stop_event = threading.Event()
        self._channels: dict[int, asyncio.Queue] = {}
        self._uids = itertools.count()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._result = None            # (finished, ServeStats) after join
        self._error: Optional[BaseException] = None

    # ---------------------------------------------------------- lifecycle

    def start(self, loop: Optional[asyncio.AbstractEventLoop] = None):
        self._loop = loop or asyncio.get_running_loop()
        self._thread = threading.Thread(target=self._run,
                                        name="engine-tick-loop",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self):
        try:
            self._result = self.engine.serve_forever(
                self.inbox, self._emit, stop=self.stop_event,
                temperature=self.temperature, seed=self.seed,
                max_burst=self.max_burst, poll_s=self.poll_s)
        except BaseException as exc:  # noqa: BLE001 — surfaced to clients
            self._error = exc
            if self._loop is not None:
                self._loop.call_soon_threadsafe(self._fail_all, exc)

    def shutdown(self):
        """Stop intake, drain in-flight work, join the engine thread.
        Returns ``(finished, stats)`` exactly like ``engine.run``."""
        self.stop_event.set()
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and self._error is None)

    def stats(self) -> dict:
        """JSON-safe stats: the final ``ServeStats`` dump after
        shutdown, a live counter snapshot while serving."""
        if self._result is not None:
            return self._result[1].to_dict()
        counters = self.engine.metrics.counters
        return {"live": True,
                "finished": int(counters.get("requests.finished", 0)),
                "rejected": int(sum(v for k, v in counters.items()
                                    if k.startswith("requests.rejected."))),
                "reject_reasons": {
                    k.removeprefix("requests.rejected."): int(v)
                    for k, v in counters.items()
                    if k.startswith("requests.rejected.")},
                "in_flight": len(self._channels)}

    # ------------------------------------------------------------- intake

    def submit(self, greq: GenerateRequest) -> tuple[int, asyncio.Queue]:
        """Register a validated request; returns ``(uid, channel)``.
        The channel yields protocol event dicts ending with a terminal
        ``done`` / ``rejected`` / ``error`` event."""
        if not self.alive:
            raise RuntimeError("engine thread is not running")
        uid = next(self._uids)
        req = P.to_engine_request(greq, uid, self.engine.cfg.vocab)
        channel: asyncio.Queue = asyncio.Queue()
        self._channels[uid] = channel
        self.inbox.put(req)
        return uid, channel

    async def events(self, uid: int, channel: asyncio.Queue):
        """Async-iterate the request's events until its terminal one."""
        while True:
            ev = await channel.get()
            yield ev
            if ev["event"] in ("done", "rejected", "error"):
                return

    # ----------------------------------------- engine thread -> event loop

    def _emit(self, event: tuple) -> None:
        """Engine-thread callback: marshal one event to its channel."""
        kind = event[0]
        if kind == "token":
            _, uid, index, token = event
            self._loop.call_soon_threadsafe(
                self._deliver, uid, P.token_event(uid, index, token), False)
        elif kind == "finished":
            fin = event[1]
            self._loop.call_soon_threadsafe(
                self._deliver, fin.request.uid, P.done_event(fin), True)
        elif kind == "rejected":
            rej = event[1]
            self._loop.call_soon_threadsafe(
                self._deliver, rej.request.uid, P.rejected_event(rej), True)

    def _deliver(self, uid: int, ev: dict, terminal: bool) -> None:
        channel = (self._channels.pop(uid, None) if terminal
                   else self._channels.get(uid))
        if channel is not None:
            channel.put_nowait(ev)

    def _fail_all(self, exc: BaseException) -> None:
        """Engine thread died: every in-flight channel gets a terminal
        wire ``error`` event (tagged with its uid) instead of waiting
        forever; ``alive`` is already False, so ``/healthz`` flips to
        503 and new submits are refused."""
        for uid, channel in self._channels.items():
            channel.put_nowait(
                P.error_event(f"engine died: {exc!r}", uid=uid))
        self._channels.clear()


class Gateway:
    """The HTTP front door. ``await start()`` binds the socket and
    spins up the engine thread; ``await close()`` tears both down and
    returns the engine's ``(finished, stats)``."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 temperature: float = 0.0, seed: int = 0,
                 max_burst: int = 8):
        self.bridge = EngineBridge(engine, temperature=temperature,
                                   seed=seed, max_burst=max_burst)
        self.engine = engine
        self.host = host
        self.port = port            # 0 = ephemeral; real port after start
        self._server: Optional[asyncio.base_events.Server] = None

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> "Gateway":
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self.bridge.start(asyncio.get_running_loop())
        return self

    async def close(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        # joining the engine thread blocks; keep the loop responsive
        return await asyncio.get_running_loop().run_in_executor(
            None, self.bridge.shutdown)

    async def serve_forever(self):
        async with self._server:
            await self._server.serve_forever()

    # --------------------------------------------------------------- http

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                head = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), timeout=30.0)
            except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                    asyncio.LimitOverrunError):
                return
            method, path, headers = self._parse_head(head)
            body = b""
            length = int(headers.get("content-length", "0"))
            if length:
                body = await reader.readexactly(length)

            if method == "GET" and path == "/healthz":
                status = "ok" if self.bridge.alive else "dead"
                await self._json(writer, 200 if status == "ok" else 503,
                                 {"status": status})
            elif method == "GET" and path == "/metrics":
                await self._json(writer, 200, {
                    "metrics": self.engine.metrics.summary(),
                    "stats": self.bridge.stats()})
            elif method == "POST" and path == "/generate":
                await self._generate(writer, body)
            else:
                await self._json(writer, 404,
                                 P.error_event(f"no route {method} {path}"))
        except ConnectionError:
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except ConnectionError:
                pass

    @staticmethod
    def _parse_head(head: bytes) -> tuple[str, str, dict]:
        lines = head.decode("latin-1").split("\r\n")
        method, path, _ = lines[0].split(" ", 2)
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                key, val = line.split(":", 1)
                headers[key.strip().lower()] = val.strip()
        return method, path, headers

    async def _generate(self, writer: asyncio.StreamWriter,
                        body: bytes) -> None:
        try:
            greq = parse_request(json.loads(body.decode("utf-8")),
                                 self.engine.cfg.vocab)
            uid, channel = self.bridge.submit(greq)
        except (ProtocolError, UnicodeDecodeError,
                json.JSONDecodeError) as exc:
            await self._json(writer, 400, P.error_event(str(exc)))
            return
        except RuntimeError as exc:
            await self._json(writer, 503, P.error_event(str(exc)))
            return
        if not greq.stream:
            last = None
            async for ev in self.bridge.events(uid, channel):
                last = ev
            # a terminal error event (engine death mid-request) must not
            # masquerade as a successful completion on the buffered path
            status = 503 if last["event"] == "error" else 200
            await self._json(writer, status, last)
            return
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/x-ndjson\r\n"
                     b"Connection: close\r\n\r\n")
        async for ev in self.bridge.events(uid, channel):
            writer.write(json.dumps(ev).encode("utf-8") + b"\n")
            await writer.drain()

    @staticmethod
    async def _json(writer: asyncio.StreamWriter, status: int,
                    obj: dict) -> None:
        reasons = {200: "OK", 400: "Bad Request", 404: "Not Found",
                   503: "Service Unavailable"}
        payload = json.dumps(obj).encode("utf-8") + b"\n"
        writer.write(
            f"HTTP/1.1 {status} {reasons.get(status, 'OK')}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n"
            f"Connection: close\r\n\r\n".encode("latin-1") + payload)
        await writer.drain()
