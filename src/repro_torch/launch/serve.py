"""Serving driver of the port (port of ``repro/launch/serve.py``): batched
autoregressive generation over the LM architectures, or DDIM sampling
from a U-Net checkpoint, in lockstep batches, through the
continuous-batching scheduler, a slot-pool fleet, or the HTTP/SSE gateway.
The flags, defaults and printed lines are JAX's, plus ``--device``
(default ``cuda``; the tests pass ``cpu``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --batch 4 --new-tokens 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --batch 4 --prompt-len 128 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch unet \\
      --ckpt results/unet/ckpt_00000300.npz --S 20 --eta 0.0
  PYTHONPATH=src python -m repro_torch.launch.serve --arch unet \\
      --scheduler --slots 4 --s-mix 10,20,50 --n-samples 12
  PYTHONPATH=src python -m repro_torch.launch.serve --arch unet \\
      --gateway --port 8807     # async HTTP/SSE front door
  PYTHONPATH=src python -m repro_torch.launch.serve --arch unet \\
      --gateway --smoke --device cpu

``--gateway`` serves the U-Net fleet behind the async front door
(serving/gateway): POST /v1/sample with ``"stream": true`` streams x0
previews + the terminal result over SSE, /v1/models lists the routable
models, and POST /v1/models/{name}/rollout hot-swaps staged weights
without dropping in-flight work. ``--gateway --smoke`` round-trips a
live client and exits. The transport needs aiohttp.

``--scheduler`` serves a mixed-step-budget request stream through
serving/scheduler: each request samples at its OWN S (--s-mix cycles),
slots refill mid-flight, and per-request latency is reported alongside
engine occupancy/throughput stats. Telemetry flags: ``--dash`` live
per-pool dashboard, ``--trace-out`` per-request JSONL spans,
``--prom-out`` Prometheus snapshot, ``--profile`` ``repro/tick/<variant>``
profiler ranges (obs/profiling.annotate); every replay ends with a
p50/p95/p99 latency + miss/drop summary table.

Weights: the U-Net init of ``--seed`` (threefry: the JAX init's numbers
for the same seed), or ``--ckpt``, a
``training/checkpoint.py`` file with a JAX-layout ``{"params", "ema"}``
U-Net tree (saved by either package), carried into the port through
``repro_torch.interop``.  ``--pools`` runs every pool on the one device
(no meshes).

``--arch <id>`` other than ``unet`` serves that architecture through
``serving.ARGenerator`` (``--smoke``: its reduced variant): every id of
the JAX package, dense, moe (deepseek-v2-236b, kimi-k2-1t-a32b), hybrid
(zamba2-2.7b), ssm (rwkv6-7b), audio (seamless-m4t-large-v2) and vlm
(llava-next-mistral-7b).  Weights: the family's ``init_params`` of
``PRNGKey(--seed)`` (JAX's numbers), or ``--ckpt``, a JAX-layout
``{"params": ...}`` file.  A vlm or audio model serves JAX's stub
embeddings, ``normal(PRNGKey(9), (batch, n_ctx_embeds, d_model)) *
0.02``: a vlm's image embeddings are prepended, so its cache grows by
``n_ctx_embeds``; an audio model's frames go to the encoder.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import configs, interop, prng
from repro_torch.core import make_schedule
from repro_torch.device import resolve_device
from repro_torch.models import get_api, unet
from repro_torch.models.vlm import stub_embeds
from repro_torch.obs import (JsonlSink, Observability, render_dashboard,
                             render_summary, summarize_results)
from repro_torch.sampling import SamplerPlan, SigmaSpec, TauSpec
from repro_torch.serving import (ARGenerator, DiffusionSampler, GenRequest,
                                 SampleRequest)
from repro_torch.training import checkpoint


def _make_obs(args) -> tuple:
    """The CLI's telemetry handle + the JSONL trace path (or None)."""
    obs = Observability(profile=args.profile)
    trace_path = args.trace_out or None
    if trace_path:
        obs.add_sink(JsonlSink(trace_path))
    return obs, trace_path


def _drain(server, dash: bool, every: int = 25):
    """Drain a scheduler engine or fleet, optionally live-dashboarding.

    ``server`` is anything with tick()/stats() and a busy predicate
    (PoolFleet has ``.busy``; the engine is busy while queued + resident
    work remains). With ``dash`` the per-pool table re-renders every
    ``every`` ticks and once at exit.
    """
    busy = ((lambda: server.busy) if hasattr(server, "busy")
            else (lambda: len(server.queue) > 0 or server.active > 0))
    results = []
    n = 0
    while busy():
        results.extend(server.tick())
        n += 1
        if dash and n % every == 0:
            print(render_dashboard(server.stats()))
    if dash:
        print(render_dashboard(server.stats()))
    return results


def _finish_replay(results, server, obs, trace_path, args) -> None:
    """Replay exit: summary table (+ dashboard), flush trace, exporters."""
    if not args.dash:               # --dash already rendered the table
        print(render_dashboard(server.stats()))
    obs.close()                     # flush + close the JSONL sink
    print(render_summary(summarize_results(results), trace_path))
    if args.prom_out:
        render = getattr(server, "render_prometheus", None)
        text = (render() if render is not None
                else server.obs.render_prometheus())
        with open(args.prom_out, "w") as f:
            f.write(text)
        print(f"metrics    {args.prom_out}")
    if getattr(args, "flight_dir", None):
        # replay postmortems on request: dump every recorder's ring so a
        # clean run's trajectory-quality history is inspectable too
        engines = ([p.engine for p in server.pools]
                   if hasattr(server, "pools") else [server])
        for eng in engines:
            flight = getattr(eng, "flight", None)
            if flight is not None:
                path = flight.dump("replay-end")
                if path is not None:
                    print(f"flight     {path}")
    if args.out:
        done = [r for r in sorted(results, key=lambda r: r.request_id)
                if r.x0 is not None]
        np.save(args.out, torch.stack([r.x0 for r in done]).cpu().numpy())
        print(f"saved -> {args.out}")


def _restore_lm(path: str, cfg, device: torch.device):
    """The LM parameters of a ``{"params": ...}`` checkpoint file holding
    the JAX-layout tree, on ``device``."""
    like = {"params": interop.map_leaves(
        interop.lm_param_shapes(cfg), lambda s: np.empty(s, np.float32))}
    restored, _ = checkpoint.restore(path, like)
    params = interop.lm_params_from_jax(restored["params"], cfg)
    return interop.map_leaves(params, lambda t: t.to(device))


def serve_lm(args):
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    api = get_api(cfg)
    device = resolve_device(args.device)
    if args.ckpt:
        params = _restore_lm(args.ckpt, cfg, device)
    else:
        params = api.init_params(prng.PRNGKey(args.seed, device), cfg,
                                 device=device)
    embeds = stub_embeds(cfg, args.batch, device)
    gen = ARGenerator(cfg, params, batch_size=args.batch,
                      max_len=args.prompt_len + args.new_tokens
                      + (cfg.n_ctx_embeds if cfg.family == "vlm" else 0),
                      device=device)
    rng = np.random.RandomState(args.seed)
    reqs = [GenRequest(prompt=rng.randint(0, cfg.vocab, args.prompt_len)
                       .astype(np.int32),
                       max_new_tokens=args.new_tokens,
                       temperature=args.temperature)
            for _ in range(args.batch)]
    results = gen.generate(reqs, embeds=embeds)
    for i, r in enumerate(results):
        print(f"req{i}: {r.tokens[:16]}...")
    print(f"prefill={results[0].prefill_ms:.1f}ms "
          f"decode={results[0].decode_ms:.1f}ms "
          f"throughput={results[0].tokens_per_s:.1f} tok/s")


def _init_unet(seed: int, device: torch.device) -> unet.UNet:
    """TOY_UNET with JAX's init of ``PRNGKey(seed)``."""
    return unet.init_params(prng.PRNGKey(seed, device), configs.TOY_UNET,
                            device=device).eval()


def _state(model: unet.UNet):
    return {k: v.detach() for k, v in model.state_dict().items()}


def _restore_unet(path: str, model: unet.UNet):
    """The (params, ema) state dicts of a checkpoint file holding the
    JAX-layout U-Net trees ``{"params", "ema"}``, on the model's device."""
    ucfg = configs.TOY_UNET
    like = interop.unet_params_to_jax(_state(model), ucfg)
    restored, _ = checkpoint.restore(path, {"params": like, "ema": like})
    device = next(model.parameters()).device
    return tuple({k: v.to(device) for k, v in interop.unet_params_from_jax(
        restored[name], ucfg).items()} for name in ("params", "ema"))


def serve_unet_gateway(args):
    """--gateway: serve the U-Net through the async HTTP/SSE front door.

    Builds a multi-model GatewayCore (serving/gateway) over slot pools:
    with --ckpt the checkpoint's 'ema' and 'raw' weight sets become two
    routable models (same trunk, hot-swap-compatible); without one, two
    differently-seeded inits stand in ('base'/'alt'). Serves on --port
    until Ctrl-C. --smoke binds an ephemeral port, round-trips one JSON
    and one streaming SSE request per model through a live aiohttp
    client, prints a one-line verdict, and exits non-zero on failure.
    """
    import asyncio

    from torch.func import functional_call

    from repro_torch.serving.gateway import HAVE_HTTP
    if not HAVE_HTTP:
        raise SystemExit("--gateway requires aiohttp for the HTTP/SSE "
                         "transport (serving/gateway/http.py)")
    from repro_torch.serving.gateway import (GatewayCore, OverloadPolicy,
                                             start_gateway, stop_gateway)

    device = resolve_device(args.device)
    schedule = make_schedule("linear", T=args.T)
    trunk = _init_unet(args.seed, device)
    if args.ckpt:
        raw, ema = _restore_unet(args.ckpt, trunk)
        models = {"ema": ema, "raw": raw}
    else:
        models = {"base": _state(trunk),
                  "alt": _state(_init_unet(args.seed + 1, device))}

    def eps_apply(params, x, t):
        return functional_call(trunk, params, (x, t))

    obs, _ = _make_obs(args)
    core = GatewayCore.build(
        schedule, eps_apply, (args.image_size, args.image_size, 3),
        models=models, pools_per_model=max(1, args.pools),
        slots=args.slots, policy=OverloadPolicy(), obs=obs,
        probes=args.probes or None, flight_dir=args.flight_dir,
        device=device)

    async def _smoke_client(port: int) -> bool:
        import aiohttp
        url = f"http://127.0.0.1:{port}"
        async with aiohttp.ClientSession() as sess:
            async with sess.get(f"{url}/v1/models") as r:
                names = sorted(await r.json())
            # JSON round-trip on one model, SSE previews on the other
            spec = {"model": names[0], "S": 4, "seed": args.seed}
            async with sess.post(f"{url}/v1/sample", json=spec) as r:
                body = await r.json()
                ok = r.status == 200 and body["event"] == "result"
            spec = {"model": names[-1], "S": 6, "seed": args.seed + 1,
                    "stream": True, "preview_every": 2}
            previews = results = 0
            async with sess.post(f"{url}/v1/sample", json=spec) as r:
                async for raw_line in r.content:
                    line = raw_line.decode("utf-8").strip()
                    if line == "event: preview":
                        previews += 1
                    elif line == "event: result":
                        results += 1
            ok = ok and results == 1 and previews > 0
            async with sess.get(f"{url}/v1/stats") as r:
                st = await r.json()
        print(f"gateway smoke: models={names} json+sse round-trips "
              f"previews={previews} requests={st['requests']} "
              f"({'OK' if ok else 'FAIL'})")
        return ok

    async def _serve() -> int:
        runner, bridge, port = await start_gateway(
            core, port=0 if args.smoke else args.port)
        if args.smoke:
            ok = await _smoke_client(port)
            await stop_gateway(runner, bridge)
            return 0 if ok else 1
        print(f"gateway listening on http://127.0.0.1:{port} "
              f"(models: {sorted(models)}; Ctrl-C to stop)")
        try:
            await asyncio.Event().wait()
        finally:
            await stop_gateway(runner, bridge)
        return 0

    try:
        rc = asyncio.run(_serve())
    except KeyboardInterrupt:
        rc = 0
    if rc:
        raise SystemExit(rc)


def serve_unet(args):
    if args.gateway:
        return serve_unet_gateway(args)
    device = resolve_device(args.device)
    schedule = make_schedule("linear", T=args.T)
    model = _init_unet(args.seed, device)
    if args.ckpt:
        _, ema = _restore_unet(args.ckpt, model)
        model.load_state_dict(ema)          # sample from the EMA model
    eps_fn = unet.make_eps_fn(model)
    bank = None
    if args.plan_bank:
        from repro_torch.autoplan import PlanBank
        bank = PlanBank.load(args.plan_bank, schedule)
        print(f"plan bank: {len(bank)} rows, NFE frontier {bank.nfes}")
    svc = DiffusionSampler(schedule, eps_fn,
                           (args.image_size, args.image_size, 3),
                           batch_size=args.batch, plan_bank=bank,
                           device=device)
    if args.scheduler:
        return serve_unet_continuous(args, svc)
    if bank is not None:
        # budget-bounded bank row: the best searched trajectory <= --S NFE
        plan = svc.bank_plan(max_nfe=args.S)
        if plan.S > args.S:
            # bank_plan falls back to the smallest row when nothing fits
            print(f"warning: no bank row fits --S {args.S}; serving the "
                  f"smallest searched row (S={plan.S})")
    else:
        plan = SamplerPlan.build(
            schedule, tau=(TauSpec.quadratic(args.S)
                           if args.tau == "quadratic"
                           else TauSpec.uniform(args.S)),
            sigma=args.eta, order=args.order)
    samples, stats = svc.serve(args.n_samples, plan, seed=args.seed)
    print(f"sampled {tuple(samples.shape)} in {stats['batches']} batches; "
          f"steady={stats['steady_batch_s']:.2f}s/batch "
          f"({stats['samples_per_s']:.2f} samples/s, {plan})")
    if args.out:
        np.save(args.out, samples.cpu().numpy())
        print(f"saved -> {args.out}")


def serve_unet_continuous(args, svc: DiffusionSampler):
    """Mixed-PLAN request stream through the continuous-batching scheduler.

    Each request carries its own frozen SamplerPlan: the S mix cycles,
    tau spacing alternates uniform/quadratic, and (with --order > 1) every
    third request upgrades to the multistep solver — all multiplexed
    through ONE tick function.
    """
    s_mix = [int(s) for s in args.s_mix.split(",")]
    stochastic = args.eta > 0.0
    max_order = args.order
    clip_x0 = None
    if svc.plan_bank is not None:
        # size the engine to the whole bank frontier: refined rows may be
        # stochastic (eta schedules), multistep, or clipped, and an engine
        # only serves bank rows within its own caps
        bank = svc.plan_bank
        stochastic = stochastic or any(bank.plan(n).stochastic
                                       for n in bank.nfes)
        max_order = max([max_order] + [e.order for e in bank.entries])
        clips = [e.clip for e in bank.entries]
        uniq = set(clips)
        if len(uniq) == 1:
            clip_x0 = uniq.pop()
        elif len(uniq) > 1:
            # an engine builds ONE clip; serve the biggest bank subset
            clip_x0 = max(uniq, key=clips.count)
            print(f"warning: bank mixes clip values "
                  f"{sorted(map(str, uniq))}; engine serves only its "
                  f"clip_x0={clip_x0} rows")
    schedule = svc.schedule
    if args.pools > 1:
        return serve_unet_fleet(args, svc, stochastic=stochastic,
                                max_order=max_order, clip_x0=clip_x0)
    obs, trace_path = _make_obs(args)
    flight = None
    if args.probes:
        from repro_torch.obs import FlightRecorder
        flight = FlightRecorder(pool_id=0, out_dir=args.flight_dir)
    eng = svc.continuous(slots=args.slots, stochastic=stochastic,
                         max_order=max_order, clip_x0=clip_x0, obs=obs,
                         probes=args.probes or None, flight=flight)

    def plan_for(i: int) -> SamplerPlan:
        S = s_mix[i % len(s_mix)]
        tau = (TauSpec.quadratic(S) if (args.tau == "quadratic"
                                        or (args.tau == "mix" and i % 2))
               else TauSpec.uniform(S))
        order = args.order if (args.order > 1 and i % 3 == 0
                               and args.eta == 0.0) else 1
        return SamplerPlan.build(schedule, tau=tau,
                                 sigma=SigmaSpec.from_eta(args.eta),
                                 order=order)

    deadlines = [float(d) for d in args.deadlines.split(",")] \
        if args.deadlines else [None]

    # warm the tick before stamping any deadline: the tick's build and the
    # kernels' first use must neither eat the requests' headroom nor — on
    # the bank path — poison the EWMA the selection policy consults
    if svc.plan_bank is not None:
        eng.submit(SampleRequest(request_id=-1, auto_plan=True, seed=0))
        eng.run()
        eng.reset_stats()        # keep the tick function + measured EWMA
    elif args.deadlines:
        eng.submit(SampleRequest(request_id=-1, plan=plan_for(0), seed=0))
        eng.run()
        eng.reset_stats()
    now = time.perf_counter()

    def deadline_for(i: int):
        d = deadlines[i % len(deadlines)]
        return None if d is None else now + d

    if svc.plan_bank is not None:
        # deadline-aware bank selection: every request lets the ENGINE
        # pick its plan at admission; the cycled relative deadlines make
        # the policy choose different NFE rows across one trace
        reqs = [SampleRequest(request_id=i, auto_plan=True,
                              deadline=deadline_for(i), seed=args.seed + i)
                for i in range(args.n_samples)]
    else:
        reqs = [SampleRequest(request_id=i, plan=plan_for(i),
                              deadline=deadline_for(i), seed=args.seed + i)
                for i in range(args.n_samples)]
    if args.dash:
        for r in reqs:
            eng.submit(r)
        results = _drain(eng, dash=True)
    else:
        results = eng.serve(reqs)
    by_id = {r.request_id: r for r in results}
    for i in sorted(by_id):
        r = by_id[i]
        sel = (f" nfe={r.nfe} headroom="
               + (f"{r.deadline_headroom_s*1e3:.0f}ms"
                  if r.deadline_headroom_s is not None else "inf")
               if r.auto_plan else "")
        print(f"req{r.request_id}: {reqs[i].plan} "
              f"wait={r.queue_wait_s*1e3:.1f}ms "
              f"service={r.service_s*1e3:.1f}ms "
              f"latency={r.latency_s*1e3:.1f}ms{sel}")
    _finish_replay(results, eng, obs, trace_path, args)


def serve_unet_fleet(args, svc: DiffusionSampler, *, stochastic,
                     max_order, clip_x0):
    """--pools N: the mixed-S stream through a slot-pool fleet.

    N continuous-batching pools behind the global EDF queue with
    least-loaded dispatch (serving/fleet), all on the service's one
    device (the JAX package's per-pool meshes are not ported). Requests
    cycle an affinity key to exercise sticky routing; per-pool stats
    print at the end.
    """
    from repro_torch.serving.fleet import PoolFleet

    s_mix = [int(s) for s in args.s_mix.split(",")]
    obs, trace_path = _make_obs(args)
    fleet = PoolFleet.build(
        svc.schedule, svc.eps_fn,
        (args.image_size, args.image_size, 3), n_pools=args.pools,
        slots=args.slots, dtype=svc.dtype,
        stochastic=stochastic, max_order=max_order, clip_x0=clip_x0,
        plan_bank=svc.plan_bank, obs=obs,
        probes=args.probes or None, flight_dir=args.flight_dir,
        device=svc.device)
    # warm every pool's tick before stamping latencies
    fleet.serve([SampleRequest(request_id=-1 - p, S=min(s_mix), seed=0)
                 for p in range(args.pools)], now=0.0)
    fleet.reset_stats()
    reqs = [SampleRequest(request_id=i, S=s_mix[i % len(s_mix)],
                          eta=args.eta, seed=args.seed + i,
                          affinity_key=i % (2 * args.pools))
            for i in range(args.n_samples)]
    if args.dash:
        for r in reqs:
            fleet.submit(r)
        results = _drain(fleet, dash=True)
    else:
        results = fleet.serve(reqs)
    for r in sorted(results, key=lambda r: r.request_id):
        print(f"req{r.request_id}: S={r.S} pool={r.pool_id} "
              f"wait={r.queue_wait_s*1e3:.1f}ms "
              f"latency={r.latency_s*1e3:.1f}ms")
    _finish_replay(results, fleet, obs, trace_path, args)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="LM archs: the reduced same-family variant")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint (.npz, training/checkpoint.py) in the "
                    "JAX layout: unet {params, ema}, LM archs {params}; "
                    "gives the JAX package's weights")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--n-samples", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--S", type=int, default=20)
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--tau", choices=["uniform", "quadratic", "mix"],
                    default="uniform",
                    help="tau spacing; 'mix' alternates per request "
                    "(--scheduler)")
    ap.add_argument("--order", type=int, default=1,
                    help="Adams-Bashforth solver order (1..4); with "
                    "--scheduler every 3rd request upgrades to it")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve through the continuous-batching scheduler")
    ap.add_argument("--gateway", action="store_true",
                    help="unet: serve through the async HTTP/SSE gateway "
                    "(serving/gateway) instead of a local replay; with "
                    "--smoke, round-trip a live client and exit")
    ap.add_argument("--port", type=int, default=8807,
                    help="--gateway: TCP port to bind (--smoke always "
                    "uses an ephemeral port)")
    ap.add_argument("--slots", type=int, default=4,
                    help="resident scheduler slots (--scheduler; per pool "
                    "with --pools)")
    ap.add_argument("--pools", type=int, default=1,
                    help="with --scheduler: serve through a fleet of N "
                    "slot pools (global EDF queue + least-loaded/affinity "
                    "routing), all on the one device")
    ap.add_argument("--s-mix", default="10,20,50",
                    help="comma list of per-request step budgets to cycle")
    ap.add_argument("--plan-bank", default=None,
                    help="PlanBank JSON (repro_torch.autoplan): lockstep "
                    "serves the best bank row <= --S; --scheduler switches "
                    "every request to deadline-aware bank selection")
    ap.add_argument("--deadlines", default="",
                    help="comma list of relative deadlines in seconds to "
                    "cycle across --scheduler requests (with --plan-bank: "
                    "drives the per-request NFE selection)")
    ap.add_argument("--dash", action="store_true",
                    help="with --scheduler: live per-pool console "
                    "dashboard re-rendered during the replay")
    ap.add_argument("--trace-out", default=None,
                    help="with --scheduler: write per-request trace spans "
                    "(structured JSONL, repro_torch.obs) to this path")
    ap.add_argument("--prom-out", default=None,
                    help="with --scheduler: write a Prometheus text "
                    "metrics snapshot at replay exit")
    ap.add_argument("--probes", action="store_true",
                    help="enable the device-probe tier (obs/probes.py): "
                         "per-slot eps/x0/finite/defect reductions in a "
                         "second tick function, quality columns in --dash, "
                         "and per-request quality summaries")
    ap.add_argument("--flight-dir", default=None,
                    help="directory for flight-recorder JSONL postmortems "
                         "(implies an in-memory ring even when faults "
                         "never fire; requires --probes)")
    ap.add_argument("--profile", action="store_true",
                    help="with --scheduler: wrap ticks in profiler ranges "
                    "(repro/tick/<variant>, obs/profiling.annotate) so a "
                    "device profile attributes time per tick variant")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the prompts and the noise")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu for the "
                    "kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.gateway and args.arch != "unet":
        ap.error("--gateway serves the diffusion fleet; use --arch unet")
    if args.order > 1 and args.eta > 0.0 and not args.scheduler:
        # multistep integrates the deterministic ODE view; the scheduler
        # path downgrades per request, the lockstep path must reject
        ap.error("--order > 1 requires --eta 0 (multistep plans are "
                 "deterministic); drop --order or use --eta 0")
    if args.arch == "unet":
        serve_unet(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
