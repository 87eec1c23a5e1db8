"""EngineBridge — the asyncio <-> engine-thread seam (port of
``repro/serving/gateway/bridge.py``).

The tick loop is synchronous and must stay single-threaded (engines,
pools, and the fleet are not locked), while the HTTP front door is an
asyncio event loop that must never block on a tick. The bridge owns ONE
daemon thread that does all engine work:

* commands (submit, hot_swap, stats, ...) arrive through a thread-safe
  queue as ``(fn, args, kwargs, Future)`` and run between pumps —
  ``call`` returns a ``concurrent.futures.Future``, ``acall`` awaits it
  from asyncio via ``asyncio.wrap_future`` (no loop blocking either
  way);
* whenever the core is busy (fleet work in flight, live streams, or a
  rollout mid-walk) the thread pumps it; when idle it parks on the
  command queue, so an idle gateway burns no CPU.

Event callbacks registered with ``GatewayCore.submit`` fire on THIS
thread (inside pump); transports must trampoline them onto their own
loop (``loop.call_soon_threadsafe`` — see gateway/http.py). A pump
exception is offered to the core's ``absorb_pump_error`` hook first
(supervised cores keep serving through a bounded number of pump
failures — docs/resilience.md); if declined it is recorded on
``.error`` and re-raised to the next caller rather than silently
killing the thread.

PyTorch specifics. Grad mode is thread-local, so the engine thread runs
its commands and pumps under its own ``torch.no_grad()`` (a caller's
``no_grad`` does not reach it). The thread issues every kernel on the
current stream, which on a fresh thread is the device's default stream:
the stream the weights and the slot tiles were written on, so no extra
synchronisation is needed, and no stream is created per thread.
"""
from __future__ import annotations

import concurrent.futures
import queue
import threading
from typing import Optional

import torch

from .core import GatewayCore


class EngineBridge:
    """One engine thread pumping a GatewayCore + a command queue into it."""

    def __init__(self, core: GatewayCore, idle_s: float = 0.05):
        self.core = core
        self.idle_s = float(idle_s)
        self.error: Optional[BaseException] = None
        self._cmds: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="gateway-engine", daemon=True)
        self._started = False

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "EngineBridge":
        self._thread.start()
        self._started = True
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._started:
            self._thread.join(timeout)

    # ------------------------------------------------------------ commands
    def call(self, fn, *args, **kwargs) -> "concurrent.futures.Future":
        """Run ``fn(*args, **kwargs)`` on the engine thread; returns a
        concurrent Future. Raises immediately if the engine thread died."""
        if self.error is not None:
            raise RuntimeError("gateway engine thread failed") \
                from self.error
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        self._cmds.put((fn, args, kwargs, fut))
        return fut

    async def acall(self, fn, *args, **kwargs):
        """Awaitable ``call`` for asyncio callers (the HTTP handlers)."""
        import asyncio
        return await asyncio.wrap_future(self.call(fn, *args, **kwargs))

    # ------------------------------------------------------------ the loop
    def _drain_commands(self, first=None) -> None:
        cmd = first
        while cmd is not None:
            fn, args, kwargs, fut = cmd
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn(*args, **kwargs))
                except BaseException as e:  # typed RequestErrors included
                    fut.set_exception(e)
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                cmd = None

    def _run(self) -> None:
        with torch.no_grad():
            self._loop()

    def _loop(self) -> None:
        while not self._stop.is_set():
            busy = self.core.busy
            try:
                first = self._cmds.get(
                    timeout=0.0 if busy else self.idle_s)
            except queue.Empty:
                first = None
            self._drain_commands(first)
            if self.core.busy:
                try:
                    self.core.pump()
                except BaseException as e:
                    # ask the core whether this pump failure is
                    # survivable (supervised cores absorb a bounded
                    # number — pool faults never get this far); if not,
                    # poison the bridge: record it, stop pumping, queued
                    # commands fail in the shutdown sweep and future
                    # call()s raise immediately
                    absorb = getattr(self.core, "absorb_pump_error", None)
                    if absorb is None or not absorb(e):
                        self.error = e
                        self._stop.set()
        # shutdown: fail anything still queued
        while True:
            try:
                _, _, _, fut = self._cmds.get_nowait()
            except queue.Empty:
                break
            if fut.set_running_or_notify_cancel():
                fut.set_exception(
                    RuntimeError("gateway engine thread stopped"))
