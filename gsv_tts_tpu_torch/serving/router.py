"""Multi-host serving router (scale-out beyond one TPU host).

The reference serves from a single process (``personal_api.py``); TPU pods
scale differently: each host runs its own ``serving.server`` over the chips
it owns (optionally dp/tp-sharded via ``T2SEngine.shard``), and this router
fans requests out across hosts over DCN:

  * **least-outstanding-requests** balancing with round-robin tiebreak;
  * **health checking** — backends are probed on ``/health`` periodically
    and after failures; unhealthy hosts are skipped until they recover
    (failure detection per SURVEY §5);
  * **transparent retry** — connection-level failures fail over to the next
    healthy backend, but only before any byte was relayed to the client
    (mid-stream upstream loss aborts the response instead);
  * **load shedding** — each backend carries at most ``max_outstanding``
    in-flight requests; when every healthy backend is saturated the router
    answers 503 + ``Retry-After`` rather than queueing unboundedly; a
    backend's OWN capacity 503 (server ``--max-streams`` admission) fails
    over to the next backend and is relayed only when every candidate shed;
  * **fan-out control plane** — ``/set_gpt_weights`` / ``/set_sovits_weights``
    broadcast to every backend so the fleet stays consistent;
  * streaming (SSE and chunked audio) is proxied incrementally, preserving
    time-to-first-audio.

Run: ``python -m gsv_tts_tpu.serving.router --backends http://h1:9880,...``
"""
from __future__ import annotations

import asyncio
import itertools
import time
from typing import Dict, List, Optional, Tuple

try:
    import aiohttp
    from aiohttp import web
except ImportError as e:  # pragma: no cover
    raise ImportError("The serving router requires `aiohttp`") from e

HOP_HEADERS = {"host", "content-length", "transfer-encoding", "connection",
               "keep-alive", "te", "trailers", "upgrade"}


class Backend:
    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.healthy = True
        self.outstanding = 0
        self.last_checked = 0.0
        self.last_health: Dict = {}

    def __repr__(self):
        return (f"Backend({self.url}, healthy={self.healthy}, "
                f"outstanding={self.outstanding})")


class Router:
    def __init__(self, backends: List[str], health_interval: float = 10.0,
                 request_timeout: float = 600.0, max_retries: int = 2,
                 max_outstanding: int = 32):
        if not backends:
            raise ValueError("router needs at least one backend URL")
        self.backends = [Backend(u) for u in backends]
        self.health_interval = health_interval
        self.request_timeout = request_timeout
        self.max_retries = max_retries
        self.max_outstanding = max_outstanding
        self._rr = itertools.count()
        self._session: Optional[aiohttp.ClientSession] = None
        self._health_task: Optional[asyncio.Task] = None
        # desired control-plane state (last weight-switch per endpoint),
        # re-applied to backends when they recover — a host that was down
        # during a broadcast must not rejoin serving the OLD model
        self._control_log: Dict[str, tuple] = {}

    # -- lifecycle ----------------------------------------------------------

    async def start(self, app=None):
        # NO total timeout: an SSE stream pacing at realtime legitimately
        # outlives any fixed total (and aiohttp raises a plain
        # asyncio.TimeoutError mid-relay for it).  Bound the connect and
        # the max gap between bytes instead.
        self._session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=None, connect=10,
                                          sock_read=self.request_timeout))
        await self._probe_all()
        self._health_task = asyncio.create_task(self._health_loop())

    async def stop(self, app=None):
        if self._health_task is not None:
            self._health_task.cancel()
            try:
                await self._health_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._session is not None:
            await self._session.close()

    # -- health -------------------------------------------------------------

    async def _probe(self, b: Backend) -> bool:
        try:
            async with self._session.get(
                    b.url + "/health",
                    timeout=aiohttp.ClientTimeout(total=5)) as r:
                b.last_health = await r.json()
                ok = r.status == 200
        except Exception:
            ok = False
        if ok and not b.healthy and self._control_log:
            # recovery: replay the desired weight state before readmitting
            # the backend, else it rejoins serving whatever model it
            # restarted with
            ok = await self._resync(b)
        b.healthy = ok
        b.last_checked = time.monotonic()
        return b.healthy

    async def _resync(self, b: Backend) -> bool:
        for path, (method, query, body, headers) in self._control_log.items():
            try:
                async with self._session.request(
                        method, b.url + path, params=query,
                        data=body or None, headers=headers) as r:
                    if r.status != 200:
                        return False
            except Exception:
                return False
        return True

    async def _probe_all(self):
        await asyncio.gather(*(self._probe(b) for b in self.backends))

    async def _health_loop(self):
        while True:
            await asyncio.sleep(self.health_interval)
            await self._probe_all()

    # -- selection ----------------------------------------------------------

    def _pick(self, exclude=()) -> Optional[Backend]:
        """Least outstanding requests among healthy backends with spare
        capacity; round-robin breaks ties so equal-load hosts alternate.
        Sheds with 503 when every healthy backend is at max_outstanding —
        queueing further work would only grow tail latency unboundedly."""
        healthy = [b for b in self.backends if b.healthy and b not in exclude]
        pool = [b for b in healthy if b.outstanding < self.max_outstanding]
        if not pool:
            if healthy:
                raise web.HTTPServiceUnavailable(
                    text="all backends at capacity",
                    headers={"Retry-After": "1"})
            # desperate fallback: retry unhealthy ones rather than 503 early
            pool = [b for b in self.backends if b not in exclude
                    and b.outstanding < self.max_outstanding]
        if not pool:
            return None
        lo = min(b.outstanding for b in pool)
        tied = [b for b in pool if b.outstanding == lo]
        return tied[next(self._rr) % len(tied)]

    # -- proxying -----------------------------------------------------------

    @staticmethod
    def _fwd_headers(request: web.Request) -> Dict[str, str]:
        return {k: v for k, v in request.headers.items()
                if k.lower() not in HOP_HEADERS}

    async def proxy_audio(self, request: web.Request) -> web.StreamResponse:
        """GET /audio/{filename}: the file lives in the TEMPDIR of whichever
        backend synthesized it, so least-loaded routing would 404 on
        (N-1)/N of fetches — try every healthy backend and relay the first
        200."""
        last_status = 404
        for b in [x for x in self.backends if x.healthy] + \
                [x for x in self.backends if not x.healthy]:
            try:
                async with self._session.get(
                        b.url + request.rel_url.path_qs.split("?")[0],
                        headers=self._fwd_headers(request)) as upstream:
                    if upstream.status != 200:
                        last_status = upstream.status
                        continue
                    resp = web.StreamResponse(status=200)
                    for k, v in upstream.headers.items():
                        if k.lower() not in HOP_HEADERS:
                            resp.headers[k] = v
                    resp.headers["X-GSV-Backend"] = b.url
                    await resp.prepare(request)
                    while True:
                        chunk = await upstream.content.readany()
                        if not chunk:
                            break
                        await resp.write(chunk)
                    await resp.write_eof()
                    return resp
            except (aiohttp.ClientError, ConnectionError, OSError):
                continue
        raise web.HTTPNotFound(
            text=f"audio not found on any backend (last status {last_status})")

    async def proxy(self, request: web.Request) -> web.StreamResponse:
        """Forward one request, streaming the body through; fail over to the
        next backend on connection errors (before any byte was relayed)."""
        body = await request.read()
        tried: List[Backend] = []
        shed_503: Optional[Tuple[bytes, Dict[str, str]]] = None
        failures = 0
        # connection-level FAILURES consume the max_retries budget; a
        # capacity 503 (healthy-but-full) only excludes that backend, so
        # the 503 is relayed strictly "when every candidate shed" no
        # matter how many replicas the fleet has
        while failures <= self.max_retries and len(tried) < len(self.backends):
            b = self._pick(exclude=tried)
            if b is None:
                break
            tried.append(b)
            b.outstanding += 1
            resp: Optional[web.StreamResponse] = None
            try:
                async with self._session.request(
                        request.method, b.url + request.rel_url.path_qs.split("?")[0],
                        params=request.rel_url.query, data=body or None,
                        headers=self._fwd_headers(request)) as upstream:
                    if upstream.status == 503:
                        # backend at capacity (server --max-streams
                        # admission): it is HEALTHY, just full — fail over
                        # to the next backend, and relay the 503 (with its
                        # Retry-After) only when every candidate shed
                        shed_503 = (await upstream.read(),
                                    {k: v for k, v in upstream.headers.items()
                                     if k.lower() not in HOP_HEADERS})
                        continue
                    resp = web.StreamResponse(status=upstream.status)
                    for k, v in upstream.headers.items():
                        if k.lower() not in HOP_HEADERS:
                            resp.headers[k] = v
                    resp.headers["X-GSV-Backend"] = b.url
                    await resp.prepare(request)
                    while True:
                        chunk = await upstream.content.readany()
                        if not chunk:
                            break
                        try:
                            await resp.write(chunk)
                        except (ConnectionResetError, OSError):
                            # the CLIENT went away mid-stream — the backend
                            # is fine: no health mark, no failover
                            return resp
                    await resp.write_eof()
                    return resp
            except (aiohttp.ClientConnectionError, aiohttp.ClientPayloadError,
                    asyncio.TimeoutError, ConnectionError):
                # asyncio.TimeoutError covers aiohttp.ServerTimeoutError AND
                # the plain timeout a ClientTimeout raises mid-read (the
                # subclassing goes ServerTimeoutError -> asyncio.TimeoutError,
                # not the other way)
                b.healthy = False  # re-probed by the health loop
                failures += 1
                if resp is not None and resp.prepared:
                    # Bytes already went to the client: failing over would
                    # prepare a second response on the same request.  Abort
                    # the CONNECTION instead (no terminating chunk) so the
                    # client sees a transfer error — a clean write_eof would
                    # make the truncated body indistinguishable from a
                    # complete one.
                    if request.transport is not None:
                        request.transport.close()
                    return resp
                continue
            finally:
                b.outstanding -= 1
        if shed_503 is not None:
            body503, hdrs = shed_503
            return web.Response(status=503, body=body503, headers=hdrs)
        raise web.HTTPServiceUnavailable(text="no healthy backend")

    async def fanout(self, request: web.Request) -> web.Response:
        """Broadcast a control-plane request (weight switches) to all
        backends; succeeds only if every healthy backend succeeded.
        Unhealthy backends are reported as deferred — the desired state is
        recorded and replayed by the health loop before they rejoin
        (``_resync``), so a host that was down during the broadcast cannot
        come back serving the old model."""
        body = await request.read()
        path = request.rel_url.path_qs.split("?")[0]
        headers = self._fwd_headers(request)
        self._control_log[path] = (request.method,
                                   dict(request.rel_url.query), body, headers)
        results = {}

        async def one(b: Backend):
            try:
                async with self._session.request(
                        request.method, b.url + path,
                        params=request.rel_url.query, data=body or None,
                        headers=headers) as r:
                    results[b.url] = {"status": r.status,
                                      "body": await r.text()}
            except Exception as e:
                results[b.url] = {"status": 0, "body": str(e)}
                b.healthy = False

        await asyncio.gather(*(one(b) for b in self.backends if b.healthy))
        for b in self.backends:
            if b.url not in results:
                results[b.url] = {"status": 0,
                                  "body": "deferred: unhealthy, will resync "
                                          "on recovery"}
        ok = all(v["status"] in (200,) or "deferred" in v["body"]
                 for v in results.values()) and any(
            v["status"] == 200 for v in results.values())
        return web.json_response({"ok": bool(ok), "backends": results},
                                 status=200 if ok else 502)

    async def health(self, request: web.Request) -> web.Response:
        """Serves the health loop's CACHED snapshot: a fresh fan-out per
        poll would multiply probe load on the backends and make the
        router's own /health block behind a hung backend's 5 s probe
        timeout.  ``?probe=1`` forces a live sweep; a never-probed state
        (start racing the first poll) probes once."""
        if request.query.get("probe") or not any(
                b.last_checked for b in self.backends):
            await self._probe_all()
        now = time.monotonic()
        return web.json_response({
            "status": "ok" if any(b.healthy for b in self.backends)
            else "degraded",
            "backends": [{
                "url": b.url, "healthy": b.healthy,
                "outstanding": b.outstanding,
                "checked_s_ago": round(now - b.last_checked, 1)
                if b.last_checked else None,
                "health": b.last_health,
            } for b in self.backends],
        })

    async def root(self, request: web.Request) -> web.Response:
        return web.json_response({
            "service": "gsv-tts-lite-tpu router",
            "backends": [b.url for b in self.backends],
            "endpoints": ["/health", "/tts", "/tts/stream", "/tts/batched",
                          "/set_gpt_weights", "/set_sovits_weights"],
        })


ROUTER_KEY = web.AppKey("gsv_router", object)


def create_router_app(backends: List[str], **kw) -> "web.Application":
    router = Router(backends, **kw)
    app = web.Application()
    app[ROUTER_KEY] = router
    app.on_startup.append(router.start)
    app.on_cleanup.append(router.stop)
    app.router.add_get("/", router.root)
    app.router.add_get("/health", router.health)
    for path in ("/tts/stream", "/tts/stream/batched", "/tts/batched",
                 "/v1/audio/speech"):
        app.router.add_post(path, router.proxy)
    app.router.add_get("/tts", router.proxy)
    app.router.add_post("/tts", router.proxy)
    # OpenAI-compat read-only listings: any backend can answer
    app.router.add_get("/v1/models", router.proxy)
    app.router.add_get("/v1/audio/voices", router.proxy)
    # audio files live on the backend that synthesized them — fan out
    app.router.add_get("/audio/{filename}", router.proxy_audio)
    for path in ("/set_gpt_weights", "/set_sovits_weights"):
        app.router.add_get(path, router.fanout)
        app.router.add_post(path, router.fanout)
    return app


def main():  # pragma: no cover - thin CLI
    import argparse

    ap = argparse.ArgumentParser(description="gsv-tts-lite-tpu multi-host router")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9870)
    ap.add_argument("--backends", required=True,
                    help="comma-separated backend base URLs")
    ap.add_argument("--health-interval", type=float, default=10.0)
    ap.add_argument("--max-outstanding", type=int, default=32,
                    help="per-backend in-flight cap; excess requests get 503")
    args = ap.parse_args()
    web.run_app(create_router_app([u for u in args.backends.split(",") if u],
                                  health_interval=args.health_interval,
                                  max_outstanding=args.max_outstanding),
                host=args.host, port=args.port)


if __name__ == "__main__":
    main()
