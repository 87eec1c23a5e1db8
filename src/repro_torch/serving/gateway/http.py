"""HTTP/SSE transport for the gateway (aiohttp; port of
``repro/serving/gateway/http.py``, the same endpoints and wire format).

Endpoints (docs/gateway.md has schemas and curl examples):

  POST /v1/sample                one sampling request. With
                                 ``"stream": true`` (or an Accept:
                                 text/event-stream header) the response
                                 is an SSE stream of ``accepted`` ->
                                 ``preview``* -> ``result``|``error``
                                 events; otherwise the handler awaits
                                 the terminal event and returns one JSON
                                 body (errors use the typed HTTP status).
                                 A client that disconnects mid-stream
                                 CANCELS its request: the slot frees,
                                 the span closes with ``cancel``.
  GET  /v1/models                resident models + versions + staged flag
  POST /v1/models/{name}/rollout start a rolling hot-swap of the model's
                                 staged checkpoint (409 when nothing is
                                 staged or a rollout is mid-walk)
  GET  /v1/stats                 the gateway stats() tree as JSON
  GET  /metrics                  Prometheus text (gateway+fleet+pools)
  GET  /healthz                  liveness + degradation: 200 with
                                 ``status: ok`` (all breakers closed) or
                                 ``status: degraded`` (still serving;
                                 quarantined-pool detail in the body);
                                 503 ``status: failed`` once the engine
                                 thread is truly dead

Transport rules: handlers never touch the core directly — every core
interaction goes through ``bridge.acall`` onto the engine thread, and
core event callbacks are trampolined back with
``loop.call_soon_threadsafe`` into a per-request asyncio queue. x0
tensors arrive on the engine's device; ``core.wire_event`` copies each to
the host (``.detach().float().cpu()``) and they cross the wire as
``{"shape": [...], "data": [flat floats]}``.
429/503 refusals carry a ``Retry-After`` header derived from the
fleet's tick EWMA (core.retry_after_s).
"""
from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional, Tuple

from aiohttp import web

from repro_torch.serving.errors import RequestError

from .bridge import EngineBridge
from .core import GatewayCore, wire_event


def _sse(name: str, payload: Dict) -> bytes:
    return (f"event: {name}\ndata: {json.dumps(payload)}\n\n"
            .encode("utf-8"))


def _retry_headers(retry_after_s) -> Optional[Dict[str, str]]:
    if retry_after_s is None:
        return None
    return {"Retry-After": str(int(retry_after_s))}


def _error_response(err: RequestError) -> "web.Response":
    return web.json_response(err.payload(), status=err.status,
                             headers=_retry_headers(err.retry_after_s))


def build_app(bridge: EngineBridge) -> "web.Application":
    core = bridge.core

    def _cancel(rid: int) -> None:
        """Best-effort cancellation from transport-level teardown (the
        bridge may already be stopping — nothing to free then)."""
        try:
            bridge.call(core.cancel, rid)
        except RuntimeError:
            pass

    async def sample(request: "web.Request") -> "web.StreamResponse":
        try:
            spec = await request.json()
        except (ValueError, UnicodeDecodeError):
            # aiohttp surfaces malformed bodies as json.JSONDecodeError
            # (a ValueError) or bad encodings — anything else is a bug
            # we want loud, not a 400
            return web.json_response(
                {"error": "bad-request", "message": "body must be JSON"},
                status=400)
        stream = bool(isinstance(spec, dict) and spec.pop("stream", False))
        stream = stream or ("text/event-stream"
                            in request.headers.get("Accept", ""))
        loop = asyncio.get_running_loop()
        events: "asyncio.Queue" = asyncio.Queue()

        def on_event(ev: Dict) -> None:   # runs on the engine thread
            loop.call_soon_threadsafe(events.put_nowait, ev)

        try:
            rid = await bridge.acall(core.submit, spec, on_event)
        except RequestError as e:
            return _error_response(e)

        if not stream:
            try:
                ev = await events.get()
                while ev["event"] == "preview":  # non-stream: drop them
                    ev = await events.get()
            except asyncio.CancelledError:
                # client went away while we waited: free the slot
                _cancel(rid)
                raise
            if ev["event"] == "error":
                return web.json_response(
                    {"error": ev["code"], "message": ev["message"],
                     "request_id": rid}, status=ev["status"],
                    headers=_retry_headers(ev.get("retry_after_s")))
            return web.json_response(wire_event(ev))

        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache",
                     "X-Accel-Buffering": "no"})
        await resp.prepare(request)
        try:
            await resp.write(_sse("accepted", {"request_id": rid}))
            while True:
                ev = await events.get()
                await resp.write(_sse(ev["event"], wire_event(ev)))
                if ev["event"] in ("result", "error"):
                    break
            await resp.write_eof()
        except asyncio.CancelledError:
            # mid-stream disconnect (client closed the SSE connection):
            # cancel the in-flight trajectory so its slot frees NOW
            # instead of ticking to completion for nobody
            _cancel(rid)
            raise
        except ConnectionResetError:
            _cancel(rid)
        return resp

    async def models(request: "web.Request") -> "web.Response":
        return web.json_response(
            await bridge.acall(core.registry.describe))

    async def rollout(request: "web.Request") -> "web.Response":
        name = request.match_info["name"]
        try:
            n_pools = await bridge.acall(core.hot_swap, name)
        except RequestError as e:
            return _error_response(e)
        except (ValueError, RuntimeError) as e:
            return web.json_response(
                {"error": "rollout-conflict", "message": str(e)},
                status=409)
        return web.json_response({"model": name, "pools": n_pools,
                                  "status": "rolling"})

    async def stats(request: "web.Request") -> "web.Response":
        return web.json_response(await bridge.acall(core.stats))

    async def metrics(request: "web.Request") -> "web.Response":
        text = await bridge.acall(core.render_prometheus)
        return web.Response(text=text,
                            content_type="text/plain", charset="utf-8")

    async def flight(request: "web.Request") -> "web.Response":
        # debug surface for the device-probe flight ring: the last N
        # probe frames + slot->request map of one pool, straight from
        # memory (no dump file needed). 404 distinguishes "no such pool /
        # pool has no recorder" from an empty-but-live ring.
        raw = request.match_info["pool"]
        try:
            pid = int(raw)
        except ValueError:
            return web.json_response(
                {"error": "bad-pool", "message": f"pool {raw!r} is not "
                 "an integer pool id"}, status=400)
        snap = await bridge.acall(core.flight_snapshot, pid)
        if snap is None:
            return web.json_response(
                {"error": "no-flight-recorder",
                 "message": f"pool {pid} does not exist or has no "
                 "flight recorder (build the gateway with probes=)"},
                status=404)
        return web.json_response(snap)

    async def healthz(request: "web.Request") -> "web.Response":
        if bridge.error is not None:
            return web.json_response(
                {"status": "failed", "error": repr(bridge.error)},
                status=503)
        body = await bridge.acall(core.health)
        # degraded still serves (reduced capacity) — 200 keeps load
        # balancers routing here; orchestrators read ``status``
        return web.json_response(body)

    app = web.Application()
    app.router.add_post("/v1/sample", sample)
    app.router.add_get("/v1/models", models)
    app.router.add_post("/v1/models/{name}/rollout", rollout)
    app.router.add_get("/v1/stats", stats)
    app.router.add_get("/v1/debug/flight/{pool}", flight)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/healthz", healthz)
    return app


async def start_gateway(core: GatewayCore, host: str = "127.0.0.1",
                        port: int = 0
                        ) -> Tuple["web.AppRunner", EngineBridge, int]:
    """Spin the bridge thread + HTTP server; returns (runner, bridge,
    bound_port). ``port=0`` binds an ephemeral port (tests/benchmarks).
    Shut down with ``await stop_gateway(runner, bridge)``."""
    bridge = EngineBridge(core).start()
    runner = web.AppRunner(build_app(bridge))
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    bound = site._server.sockets[0].getsockname()[1]
    return runner, bridge, bound


async def stop_gateway(runner: "web.AppRunner",
                       bridge: EngineBridge) -> None:
    await runner.cleanup()
    bridge.stop()
