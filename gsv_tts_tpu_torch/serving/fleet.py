"""Single-host multi-card dp serving supervisor (counterpart of
``gsv_tts_tpu/serving/fleet.py``).

The inference scale-out on a host with several cards is **dp replicas**:
one pinned ``serving.server`` process per card.  This supervisor:

  * spawns one server subprocess per card (``--device i --port base+i``),
    each pinning its engine to one card: with per-process card isolation
    (``chip_env``) the replica sees only its card (``CUDA_VISIBLE_DEVICES``)
    and takes ``cuda:0``, else it takes ``cuda:i``;
  * waits for every replica's ``/health``;
  * fronts them with the serving router (least-loaded balancing, health
    probes, failover, shedding — ``serving/router.py``) in this process;
  * restarts crashed replicas with bounded backoff (failure recovery the
    reference lacks entirely; its ``personal_api.py`` serves one GPU from
    one unsupervised process).

Run: ``python -m gsv_tts_tpu_torch.serving.fleet --models-dir ... --gpt ... \
         --sovits ... [--devices 0,1,2,3] [--ports-base 9890] [--port 9880]``
"""
from __future__ import annotations

import asyncio
import logging
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("gsv.fleet")


class FleetSupervisor:
    """Process supervisor for N pinned server replicas.

    ``cmd_factory(device_index, port) -> argv`` builds each replica's
    command line (injectable for tests); the default builds the real
    ``gsv_tts_tpu_torch.serving.server`` invocation from ``server_args``.
    """

    def __init__(self, devices: List[int], ports_base: int = 9890,
                 host: str = "127.0.0.1",
                 cmd_factory: Optional[Callable[[int, int], List[str]]] = None,
                 server_args: Optional[List[str]] = None,
                 max_restarts: int = 3, backoff_s: float = 1.0,
                 env: Optional[dict] = None, chip_env: str = "auto"):
        self.devices = list(devices)
        self.ports_base = ports_base
        self.host = host
        self.server_args = server_args or []
        self.cmd_factory = cmd_factory or self._default_cmd
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.env = env
        #: per-process card isolation ("auto"/"on"/"off"): each replica sees
        #: only its card (CUDA_VISIBLE_DEVICES=<card>), so no replica makes a
        #: CUDA context on another's card; "auto" isolates when this host
        #: has CUDA cards
        self.chip_env = chip_env
        self.procs: Dict[int, subprocess.Popen] = {}
        self.restarts: Dict[int, int] = {d: 0 for d in self.devices}
        self.dead: List[int] = []
        #: replicas being deliberately cycled by ``rolling_restart`` — the
        #: crash monitor must not treat their planned exit as a crash
        self.restarting: set = set()

    # -- replica lifecycle ---------------------------------------------------

    def _chip_env_active(self) -> bool:
        if self.chip_env in ("on", "off"):
            return self.chip_env == "on"
        # auto: when this host has CUDA cards (counting them makes no
        # context on any of them)
        import torch

        return torch.cuda.is_available()

    def _default_cmd(self, device: int, port: int) -> List[str]:
        # under card isolation each replica sees exactly ONE card, so the
        # in-process pin is always cuda:0
        dev = "0" if self._chip_env_active() else str(device)
        return [sys.executable, "-m", "gsv_tts_tpu_torch.serving.server",
                "--host", self.host, "--port", str(port),
                "--device", dev] + self.server_args

    def port_for(self, device: int) -> int:
        return self.ports_base + self.devices.index(device)

    def backend_urls(self) -> List[str]:
        return [f"http://{self.host}:{self.port_for(d)}" for d in self.devices]

    def spawn(self, device: int) -> subprocess.Popen:
        cmd = self.cmd_factory(device, self.port_for(device))
        env = dict(os.environ if self.env is None else self.env)
        env.setdefault("PYTHONPATH", os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        if self._chip_env_active():
            # one visible card per replica: the i-th of those this process
            # was given, or card i
            visible = env.get("CUDA_VISIBLE_DEVICES")
            env["CUDA_VISIBLE_DEVICES"] = (visible.split(",")[device] if visible
                                           else str(device))
        proc = subprocess.Popen(cmd, env=env)
        self.procs[device] = proc
        log.info("fleet: replica device=%d port=%d pid=%d", device,
                 self.port_for(device), proc.pid)
        return proc

    def spawn_all(self):
        for d in self.devices:
            self.spawn(d)

    async def wait_healthy(self, timeout_s: float = 300.0,
                           interval_s: float = 1.0) -> bool:
        """Poll every replica's /health until all answer 200 (bounded)."""
        import aiohttp

        deadline = time.monotonic() + timeout_s
        pending = set(self.backend_urls())
        async with aiohttp.ClientSession() as session:
            while pending and time.monotonic() < deadline:
                done = set()
                for url in pending:
                    try:
                        async with session.get(
                                url + "/health",
                                timeout=aiohttp.ClientTimeout(total=3)) as r:
                            if r.status == 200:
                                done.add(url)
                    except Exception:
                        pass
                pending -= done
                if pending:
                    await asyncio.sleep(interval_s)
        return not pending

    async def monitor(self, interval_s: float = 2.0):
        """Restart crashed replicas with bounded backoff; replicas past the
        restart budget are left to the router's health checks to route
        around (marked in ``self.dead``).  Backoffs are tracked per replica
        as wake times — never awaited inline — so one flapping replica's
        delay cannot stall crash detection or restarts of the others."""
        pending: Dict[int, float] = {}  # device -> monotonic restart time
        while True:
            now = time.monotonic()
            sleep_s = interval_s
            if pending:
                sleep_s = min(sleep_s,
                              max(0.05, min(pending.values()) - now))
            await asyncio.sleep(sleep_s)
            now = time.monotonic()
            for d in [d for d, t in pending.items() if now >= t]:
                del pending[d]
                if d in self.restarting:
                    # rolling_restart took this device over mid-backoff; a
                    # spawn here would double-bind the port and orphan the
                    # replica rolling_restart brings up — drop the entry
                    continue
                try:
                    self.spawn(d)
                except OSError as exc:
                    # transient Popen failure (EAGAIN/ENOMEM — exactly the
                    # conditions replicas crash under) must not kill the
                    # monitor task; re-schedule with another backoff step
                    log.warning("fleet: spawn device=%d failed (%s) — "
                                "retrying", d, exc)
                    self.restarts[d] += 1
                    if self.restarts[d] > self.max_restarts:
                        self.dead.append(d)
                        continue
                    pending[d] = now + self.backoff_s * (
                        2 ** (self.restarts[d] - 1))
            for d, proc in list(self.procs.items()):
                if (proc.poll() is None or d in self.dead or d in pending
                        or d in self.restarting):
                    continue
                self.restarts[d] += 1
                if self.restarts[d] > self.max_restarts:
                    log.error("fleet: replica device=%d exceeded restart "
                              "budget (%d); leaving down", d, self.max_restarts)
                    self.dead.append(d)
                    continue
                delay = self.backoff_s * (2 ** (self.restarts[d] - 1))
                log.warning("fleet: replica device=%d exited rc=%s — "
                            "restart %d/%d in %.1fs", d, proc.returncode,
                            self.restarts[d], self.max_restarts, delay)
                pending[d] = time.monotonic() + delay

    async def rolling_restart(self, drain_timeout_s: float = 60.0,
                              health_timeout_s: float = 300.0,
                              interval_s: float = 0.5) -> bool:
        """Cycle every live replica ONE AT A TIME, hitless behind the
        router: POST /drain (synthesis 503s → the router's capacity
        failover routes around it), wait for its in-flight streams to
        finish, terminate, respawn (with ``--warmup`` in ``server_args``
        the new process compiles before listening), and wait for /health
        200 before touching the next replica.  Pair with ``--warmup`` for
        zero-compile-hit deploys; the reference's single process can only
        hard-restart (its clients see connection resets).

        Returns True when every replica cycled back to healthy; stops
        early (leaving the remaining replicas serving) if one fails to
        come back within ``health_timeout_s``.
        """
        import aiohttp

        async def _health(session, url):
            async with session.get(
                    url + "/health",
                    timeout=aiohttp.ClientTimeout(total=3)) as r:
                return r.status, (await r.json() if r.status == 200 else {})

        async with aiohttp.ClientSession() as session:
            for d in list(self.devices):
                if d in self.dead:
                    continue
                url = f"http://{self.host}:{self.port_for(d)}"
                self.restarting.add(d)
                try:
                    # drain, then wait for in-flight streams to finish
                    # (an unreachable replica is simply cycled)
                    try:
                        await session.post(
                            url + "/drain", json={"enable": True},
                            timeout=aiohttp.ClientTimeout(total=5))
                    except Exception:  # noqa: BLE001 — dead replica: respawn
                        pass
                    else:
                        deadline = time.monotonic() + drain_timeout_s
                        while time.monotonic() < deadline:
                            try:
                                status, h = await _health(session, url)
                                if status != 200 or not h.get("inflight"):
                                    break
                            except Exception:  # noqa: BLE001 — transient
                                # health-poll hiccup (e.g. a timeout while
                                # the replica finishes streams) must not
                                # hard-kill in-flight work: keep waiting
                                pass
                            await asyncio.sleep(interval_s)
                    proc = self.procs.get(d)
                    if proc is not None and proc.poll() is None:
                        proc.terminate()
                        try:
                            await asyncio.to_thread(proc.wait, 10)
                        except subprocess.TimeoutExpired:
                            proc.kill()
                            await asyncio.to_thread(proc.wait, 5)
                    try:
                        self.spawn(d)
                    except OSError as exc:
                        log.error("fleet: rolling restart spawn device=%d "
                                  "failed: %s", d, exc)
                        return False
                    deadline = time.monotonic() + health_timeout_s
                    up = False
                    while time.monotonic() < deadline:
                        try:
                            status, _ = await _health(session, url)
                            if status == 200:
                                up = True
                                break
                        except Exception:  # noqa: BLE001 — still starting
                            pass
                        await asyncio.sleep(interval_s)
                    if not up:
                        log.error("fleet: rolling restart device=%d never "
                                  "became healthy; stopping the roll", d)
                        return False
                    log.info("fleet: rolling restart device=%d done", d)
                finally:
                    self.restarting.discard(d)
        return True

    def shutdown(self, grace_s: float = 10.0):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + grace_s
        for proc in self.procs.values():
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)


def add_fleet_routes(app, fleet: FleetSupervisor):
    """Fleet ops surface on the fronting router app: POST /fleet/restart
    kicks off a hitless rolling restart in the background (409 while one
    is already running); GET /fleet/status reports supervisor state and
    the last roll's outcome."""
    from aiohttp import web

    roll = {"task": None, "last_ok": None}

    def _record_roll_outcome(t):
        # retrieve the exception here (not lazily in /fleet/status) so an
        # unexpected failure is logged instead of dying as an asyncio
        # "Task exception was never retrieved" warning
        if t.cancelled():
            roll["last_ok"] = False
            log.warning("fleet: rolling restart task cancelled")
        elif t.exception() is not None:
            roll["last_ok"] = False
            log.error("fleet: rolling restart task failed: %r", t.exception())
        else:
            roll["last_ok"] = bool(t.result())

    async def fleet_restart(request):
        t = roll["task"]
        if t is not None and not t.done():
            return web.json_response(
                {"error": "rolling restart already in progress"}, status=409)
        roll["task"] = asyncio.create_task(fleet.rolling_restart())
        roll["task"].add_done_callback(_record_roll_outcome)
        return web.json_response({"status": "restarting",
                                  "devices": fleet.devices})

    async def fleet_status(request):
        t = roll["task"]
        last_ok = roll["last_ok"]
        return web.json_response({
            "devices": fleet.devices,
            "dead": fleet.dead,
            "restarts": {str(d): n for d, n in fleet.restarts.items()},
            "pids": {str(d): p.pid for d, p in fleet.procs.items()},
            "rolling_restart_active": bool(t is not None and not t.done()),
            "last_rolling_restart_ok": last_ok,
        })

    app.router.add_post("/fleet/restart", fleet_restart)
    app.router.add_get("/fleet/status", fleet_status)
    return app


def main():  # pragma: no cover - thin CLI over the tested pieces
    import argparse

    from aiohttp import web

    from .router import create_router_app

    ap = argparse.ArgumentParser(
        description="gsv-tts-lite single-host dp fleet on the PyTorch port: one "
                    "pinned server per card + fronting router")
    ap.add_argument("--host", default="0.0.0.0", help="router bind host")
    ap.add_argument("--port", type=int, default=9880, help="router port")
    ap.add_argument("--replica-host", default="127.0.0.1",
                    help="bind host for the per-card replicas")
    ap.add_argument("--ports-base", type=int, default=9890,
                    help="replica i listens on ports-base + i")
    ap.add_argument("--devices", default=None,
                    help="comma list of CUDA card indices (default: all)")
    ap.add_argument("--max-outstanding", type=int, default=8,
                    help="router per-replica in-flight cap")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--chip-env", choices=("auto", "on", "off"),
                    default="auto",
                    help="per-replica card isolation (CUDA_VISIBLE_DEVICES="
                         "<card>, the replica pinned to cuda:0); auto "
                         "enables it when this host has CUDA cards")
    # replica passthrough flags
    ap.add_argument("--models-dir", default=None)
    ap.add_argument("--gpt", default=None)
    ap.add_argument("--sovits", default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--quant-t2s", nargs="?", const="int8", default=False,
                    choices=("int8", "int4"))
    ap.add_argument("--quant-bert", action="store_true")
    ap.add_argument("--featurizer-buckets", action="store_true")
    ap.add_argument("--stream-share", action="store_true")
    ap.add_argument("--warmup", action="store_true",
                    help="each replica captures its serving graphs BEFORE "
                         "listening (server --warmup): wait_healthy then "
                         "means 'ready to serve capture-free', and a "
                         "rolling restart is hitless")
    ap.add_argument("--max-streams", type=int, default=None,
                    help="per-replica admission cap on concurrent shared "
                         "streaming clients (server --max-streams): past it"
                         " a replica 503s and the router fails over/sheds")
    ap.add_argument("--batch-window-ms", type=float, default=0.0)
    ap.add_argument("--batch-max", type=int, default=4)
    ap.add_argument("--voices", default=None,
                    help="JSON voice registry for the OpenAI-compatible "
                         "surface (forwarded to every replica)")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO)
    if args.devices:
        devices = [int(x) for x in args.devices.split(",")]
    else:
        # count the cards in a SUBPROCESS: the supervisor itself makes no
        # CUDA context, on any card
        out = subprocess.run(
            [sys.executable, "-c", "import torch; print(torch.cuda.device_count())"],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"device enumeration failed: {out.stderr}")
        devices = list(range(int(out.stdout.strip().splitlines()[-1])))
        if not devices:
            raise SystemExit("no CUDA card to serve from (pass --devices)")

    passthrough: List[str] = []
    for flag in ("models_dir", "gpt", "sovits", "dtype", "voices"):
        v = getattr(args, flag)
        if v:
            passthrough += ["--" + flag.replace("_", "-"), str(v)]
    if args.quant_t2s:
        passthrough += ["--quant-t2s", str(args.quant_t2s)]
    if args.quant_bert:
        passthrough.append("--quant-bert")
    if args.featurizer_buckets:
        passthrough.append("--featurizer-buckets")
    if args.stream_share:
        passthrough.append("--stream-share")
    if args.warmup:
        passthrough.append("--warmup")
    if args.max_streams is not None:
        passthrough += ["--max-streams", str(args.max_streams)]
    if args.batch_window_ms:
        passthrough += ["--batch-window-ms", str(args.batch_window_ms)]
    passthrough += ["--batch-max", str(args.batch_max)]

    fleet = FleetSupervisor(devices, ports_base=args.ports_base,
                            host=args.replica_host, server_args=passthrough,
                            max_restarts=args.max_restarts,
                            chip_env=args.chip_env)
    fleet.spawn_all()

    app = create_router_app(fleet.backend_urls(),
                            max_outstanding=args.max_outstanding)
    add_fleet_routes(app, fleet)

    async def _start(app):
        # monitor FIRST: a replica that crashes during model load/compile
        # (chip-claim race, OOM while every replica compiles at once) gets
        # supervised through the startup window too — waiting for health
        # first would leave startup crashes unrestarted for the whole
        # wait_healthy timeout
        app["fleet_monitor"] = asyncio.create_task(fleet.monitor())
        ok = await fleet.wait_healthy()
        if not ok:
            log.error("fleet: not all replicas became healthy; router will "
                      "route around the missing ones")

    async def _stop(app):
        task = app.get("fleet_monitor")
        if task is not None:
            task.cancel()
        fleet.shutdown()

    app.on_startup.append(_start)
    app.on_cleanup.append(_stop)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
