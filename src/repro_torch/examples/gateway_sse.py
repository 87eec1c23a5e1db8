"""Streaming a diffusion sample over the gateway's SSE front door (port of
``examples/gateway_sse.py``).

The async gateway (``repro_torch.serving.gateway``) exposes the slot-pool
fleet as HTTP: POST /v1/sample with ``"stream": true`` answers with a
Server-Sent-Events stream —

  event: accepted   {"request_id": 0}
  event: preview    {"request_id": 0, "step": 4, "x0": {...}}   (repeats)
  event: result     {"request_id": 0, "x0": {...}, "latency_s": ...}

so a client watches x0 sharpen WHILE the request's remaining DDIM steps
run.  This example is the wire-protocol walkthrough: it starts an
in-process two-model gateway over the fleet's demo trunk
(``serving.fleet.make_trunk_params`` / ``trunk_apply``; every pool tick
launches B2, the per-row sampler step kernel, on the card), streams one
request per model, and prints every SSE event as it arrives.  Point
``--url`` at a running ``python -m repro_torch.launch.serve --arch unet
--gateway`` to stream from a real server instead.  The transport needs
``aiohttp``; without it the example raises and names the package.

  PYTHONPATH=src python -m repro_torch.examples.gateway_sse
  PYTHONPATH=src python -m repro_torch.examples.gateway_sse \\
      --url http://127.0.0.1:8807
  PYTHONPATH=src python -m repro_torch.examples.gateway_sse --smoke \\
      --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import json

import numpy as np


def _aiohttp():
    try:
        import aiohttp
    except ImportError as e:
        raise RuntimeError("gateway_sse needs the 'aiohttp' package for "
                           "its HTTP/SSE client and server") from e
    return aiohttp


async def stream_one(sess, url: str, spec: dict) -> dict:
    """POST one streaming request; print each SSE event, return a tally.

    The SSE wire format is line-based: ``event: <name>`` then ``data:
    <json>`` then a blank line. x0 payloads arrive flattened as
    ``{"shape": [...], "data": [floats]}`` — ``np.reshape`` restores the
    array.
    """
    tally = {"previews": 0, "result": None, "error": None}
    async with sess.post(f"{url}/v1/sample",
                         json={**spec, "stream": True}) as resp:
        name = None
        async for raw in resp.content:
            line = raw.decode("utf-8").strip()
            if line.startswith("event: "):
                name = line[len("event: "):]
                continue
            if not line.startswith("data: "):
                continue                       # blank separator line
            ev = json.loads(line[len("data: "):])
            if name == "accepted":
                print(f"  accepted  request_id={ev['request_id']}")
            elif name == "preview":
                x0 = np.reshape(ev["x0"]["data"], ev["x0"]["shape"])
                tally["previews"] += 1
                print(f"  preview   step={ev['step']:>3}  "
                      f"|x0|={float(np.abs(x0).mean()):.3f}")
            elif name == "result":
                tally["result"] = ev
                print(f"  result    S={ev['S']} pool={ev['pool_id']} "
                      f"latency={ev['latency_s'] * 1e3:.1f}ms "
                      f"previews={ev['previews']}")
            elif name == "error":
                tally["error"] = ev
                print(f"  error     {ev['code']}: {ev['message']}")
    return tally


async def run_client(url: str, S: int):
    """Stream one request per model; returns (ok, {model: tally})."""
    aiohttp = _aiohttp()
    ok = True
    tallies = {}
    async with aiohttp.ClientSession() as sess:
        async with sess.get(f"{url}/v1/models") as resp:
            models = await resp.json()
        print(f"models: {json.dumps(models)}")
        for i, name in enumerate(sorted(models)):
            print(f"streaming model '{name}':")
            tally = await stream_one(sess, url, {
                "model": name, "S": S, "seed": i,
                "preview_every": max(S // 4, 1)})
            tallies[name] = tally
            ok = ok and tally["result"] is not None \
                and tally["previews"] > 0 and tally["error"] is None
    return ok, tallies


async def run_in_process(S: int, device=None):
    """No server around: spin a tiny two-model gateway and stream from it.

    Returns (ok, tallies, the gateway's stats() read before it stops).
    The fleet's MLP eps-trunk keeps the demo checkpoint-free; a real
    deployment passes its own ``eps_apply`` + weights to
    GatewayCore.build.
    """
    _aiohttp()
    from repro_torch.core import make_schedule
    from repro_torch.device import resolve_device
    from repro_torch.serving.fleet import make_trunk_params, trunk_apply
    from repro_torch.serving.gateway import (GatewayCore, OverloadPolicy,
                                             start_gateway, stop_gateway)

    dev = resolve_device(device)
    schedule = make_schedule("linear", T=1000)
    dim, hidden = 8, 64
    core = GatewayCore.build(
        schedule, trunk_apply, (dim,),
        models={"base": make_trunk_params(schedule, dim, hidden, seed=0,
                                          device=dev),
                "alt": make_trunk_params(schedule, dim, hidden, seed=1,
                                         device=dev)},
        slots=2, policy=OverloadPolicy(), device=dev)
    runner, bridge, port = await start_gateway(core, port=0)
    try:
        ok, tallies = await run_client(f"http://127.0.0.1:{port}", S)
        stats = await bridge.acall(core.stats)
    finally:
        await stop_gateway(runner, bridge)
    return ok, tallies, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default=None,
                    help="gateway base URL (default: start one in-process)")
    ap.add_argument("--S", type=int, default=12,
                    help="DDIM step budget per streamed request")
    ap.add_argument("--smoke", action="store_true",
                    help="exit non-zero unless every stream delivered "
                    "previews and a terminal result")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the in-process gateway "
                    "(default cuda)")
    args = ap.parse_args(argv)
    stats = None
    if args.url:
        ok, tallies = asyncio.run(run_client(args.url, args.S))
    else:
        ok, tallies, stats = asyncio.run(run_in_process(args.S, args.device))
    print(f"gateway sse example: {'OK' if ok else 'FAIL'}")
    rc = 0 if ok else (1 if args.smoke else 0)
    return {"ok": ok, "rc": rc, "streams": tallies, "stats": stats}


if __name__ == "__main__":
    raise SystemExit(main()["rc"])
