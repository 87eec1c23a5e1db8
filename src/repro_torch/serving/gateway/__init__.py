"""Async serving gateway — the fleet's streaming front door (port of
``repro.serving.gateway``).

Layering (each importable on its own):

  core.GatewayCore        synchronous front-door state machine: typed
                          admission, overload shedding, event delivery,
                          rolling weight hot-swap over a PoolFleet
  admission.OverloadPolicy  shed-before-tick policy (feasibility + depth)
  registry.ModelRegistry  resident/staged checkpoints with versions
  bridge.EngineBridge     the one engine thread pumping the core +
                          a command queue (asyncio-safe call/acall)
  http                    aiohttp HTTP/SSE transport (optional import —
                          everything else works without aiohttp)

docs/gateway.md (written for the JAX package) describes the endpoints,
the SSE event schema, the overload policy and the hot-swap walkthrough;
the port keeps all of them.
"""
from .admission import OverloadPolicy
from .bridge import EngineBridge
from .core import GatewayCore, parse_spec
from .registry import ModelRegistry

try:                                    # transport only with aiohttp
    from .http import build_app, start_gateway, stop_gateway
    HAVE_HTTP = True
except ImportError:                     # pragma: no cover - env without it
    HAVE_HTTP = False
    build_app = start_gateway = stop_gateway = None

__all__ = ["EngineBridge", "GatewayCore", "HAVE_HTTP", "ModelRegistry",
           "OverloadPolicy", "build_app", "parse_spec", "start_gateway",
           "stop_gateway"]
