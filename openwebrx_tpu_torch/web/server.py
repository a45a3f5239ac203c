"""Server entry point: routes + boot/shutdown ordering.

Reference ``owrx/__main__.py:51-195`` (boot: config → features → sources →
services → HTTP; orderly shutdown) as an asyncio app.

Run:  python -m openwebrx_tpu_torch.web.server [--port 8073] [--config settings.json]
      [--signal-demo]   # synthetic multi-signal source, no hardware needed
      [--device cuda]   # the torch device of every DeviceRuntime; cpu runs
                        # the plain PyTorch path (tests, development)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal

from openwebrx_tpu_torch import __version__
from openwebrx_tpu_torch.core.config import Config
from openwebrx_tpu_torch.core.feature import FeatureDetector
from openwebrx_tpu_torch.sdr import SdrService
from openwebrx_tpu_torch.web.connection import handle_websocket
from openwebrx_tpu_torch.web.http import HttpServer, Router, Request, json_response, serve_static

logger = logging.getLogger(__name__)


def build_router() -> Router:
    router = Router()

    def status(request: Request):
        config = Config.get()
        # receiver directories authenticate a listed receiver by sending
        # an "Authorization: ReceiverId <challenges>" header; answer with
        # signed responses (reference: owrx/controllers/receiverid.py)
        headers = None
        auth = request.headers.get("authorization")
        if auth:
            from openwebrx_tpu_torch.core.receiverid import KeyError_, response_header
            try:
                signed = response_header(auth)
                if signed:
                    headers = {"Authorization": signed}
            except KeyError_:
                pass
        return json_response(headers=headers, data={
            "receiver": {k: config.get(k) for k in
                         ("receiver_name", "receiver_location", "receiver_asl",
                          "receiver_admin", "receiver_gps")},
            "version": __version__,
            "sdrs": [{"id": s.id, "name": s.get_name(),
                      "state": str(s.get_state()), "failed": s.is_failed()}
                     for s in SdrService.get_sources().values()],
            "max_clients": config.get("max_clients"),
        })

    def features(request: Request):
        return json_response(FeatureDetector().feature_report())

    def metrics(request: Request):
        from openwebrx_tpu_torch.core.metrics import Metrics
        return json_response(Metrics.shared().get_hierarchical())

    def metrics_prometheus(request: Request):
        from openwebrx_tpu_torch.core.metrics import Metrics
        from openwebrx_tpu_torch.web.http import response
        return response(200, Metrics.shared().render_prometheus().encode(),
                        "text/plain; version=0.0.4")

    def lookup(request: Request):
        """Callsign / MMSI / ICAO-address lookup for the frontend Lookup
        panel and table flags (reference owrx/lookup.py + owrx/icao.py
        surfaces).  Every kind carries a ``ccode`` for flag rendering."""
        import re as _re
        from openwebrx_tpu_torch.core.lookup import HamCallsign, MmsiNumber
        q = (request.query.get("q") or "").strip()
        if not q:
            return json_response({"error": "missing q"}, status=400)
        if q.isdigit() and len(q) in (7, 8, 9):
            info = MmsiNumber.parse(q.zfill(9))
            info["kind"] = "mmsi"
            country = info.get("country")
            if country:
                from openwebrx_tpu_torch.core.lookup import CountryCode
                # MID table stores names; map back to an ISO code if known
                code = CountryCode.from_name(country)
                if code:
                    info["ccode"] = code
            return json_response(info)
        # 24-bit ICAO hex address → registration + country.  6-hex-char
        # strings are ambiguous with amateur callsigns (DF1ABC is both) —
        # aircraft callers pass kind=aircraft explicitly; the heuristic
        # path only treats hex as aircraft when it is NOT a valid callsign
        want_aircraft = request.query.get("kind") == "aircraft"
        is_hex = bool(_re.fullmatch(r"[0-9a-fA-F]{6}", q))
        entry = None if want_aircraft else HamCallsign.get_country(q)
        if is_hex and entry is None:
            from openwebrx_tpu_torch.services.icao import enrich
            info = enrich(q)
            if info:
                info.update(kind="aircraft", query=q)
                return json_response(info)
        out = {"kind": "callsign", "query": q}
        if entry:
            out["itu_code"], out["country"] = entry
            out["ccode"] = entry[0]
        return json_response(out)

    def bands(request):
        """Bandplan API: the active plan, or ?region=r1|r2|r3 for a
        shipped regional pack (reference ships bands-r{1,2,3}.json)."""
        from openwebrx_tpu_torch.core.bands import Bandplan, load_region, REGIONS
        region = request.query.get("region")
        if region:
            try:
                plan = load_region(region)
            except (KeyError, OSError):
                return json_response({"error": f"unknown region {region}",
                                      "regions": list(REGIONS)}, status=404)
        else:
            plan = Bandplan.shared().bands
        return json_response({
            "regions": list(REGIONS),
            "bands": [{"name": b.name, "lower_bound": b.low,
                       "upper_bound": b.high, "tags": b.tags,
                       "frequencies": b.frequencies} for b in plan]})

    router.add("/status.json", status)
    router.add("/api/bands", bands)
    router.add("/api/lookup", lookup)
    router.add("/api/features", features)
    router.add("/metrics.json", metrics)
    router.add("/metrics", metrics_prometheus)
    from openwebrx_tpu_torch.web.settings import register_routes
    register_routes(router)
    router.add_regex(r"^/(?!ws/).*$", serve_static)
    router.websocket_handler = lambda request: handle_websocket(request, SdrService)
    return router


SIGNAL_DEMO_CONFIG = {
    "name": "Synthetic Demo",
    "type": "signal",
    "samp_rate": 2400000,
    "center_freq": 145000000,
    "throttle": True,
    "noise": 2e-4,
    "signals": [
        {"kind": "nfm", "offset_hz": 145000.0, "f_audio": 1000.0, "amplitude": 0.4},
        {"kind": "nfm", "offset_hz": -350000.0, "f_audio": 440.0, "amplitude": 0.3},
        {"kind": "am", "offset_hz": -200000.0, "f_audio": 800.0, "amplitude": 0.3},
        {"kind": "usb", "offset_hz": 300000.0, "f_audio": 1500.0, "amplitude": 0.2},
        {"kind": "packet", "offset_hz": 250000.0, "amplitude": 0.4,
         "source": "W1AW-1", "info": "!4903.50N/07201.75W-demo beacon"},
    ],
    "profiles": {
        "default": {"name": "Demo", "center_freq": 145000000,
                    "samp_rate": 2400000, "start_freq": 145145000,
                    "start_mod": "nfm", "tuning_step": "5000"},
    },
}


def make_ssl_context():
    """https auto-enables when cert+key exist at the configured paths
    (reference: owrx/__main__.py:160-167)."""
    import os
    import ssl
    from openwebrx_tpu_torch.core.config import CoreConfig
    cert = CoreConfig.defaults["ssl_cert"]
    key = CoreConfig.defaults["ssl_key"]
    if not (os.path.isfile(cert) and os.path.isfile(key)):
        logger.info("no SSL certificate at %s, serving plain http", cert)
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    return ctx


def open_device(name: str):
    """The torch device every DeviceRuntime of this server runs on.  A card
    that is asked for must be there (nothing falls back to the CPU), and
    every kernel is built on it before the server listens, so that neither
    a missing card nor a failed ``nvcc`` waits for the first listener (the
    runtimes themselves are built on a source's first client)."""
    from openwebrx_tpu_torch import kernels, resolve_device
    try:
        device = resolve_device(name)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"--device {name}: {e}. Run with --device cpu to "
                         "serve from the CPU.")
    if device.type == "cuda":
        logger.info("kernels built in %.1f s", kernels.build_all())
    return device


def warm_sources(device) -> None:
    """On a card, pay the process's one-time costs of every configured
    source's banks (CUDA module loads, cuDNN, cuFFT plans, the kernels'
    libraries) through throwaway runtimes (``SdrService.warm``) before the
    server listens, so that first audio on a bank new to the process does
    not wait for them (the reference keeps a persistent compilation cache
    for the same reason).  On the CPU there is nothing to warm.  A failure
    stops the server."""
    if device.type != "cuda":
        return
    try:
        seconds = SdrService.warm()
    except Exception as e:
        logger.exception("warm-up failed")
        raise SystemExit(f"warm-up on {device} failed: {e!r}") from e
    logger.info("warmed in %.1f s", seconds)


async def main_async(args):
    SdrService.device = open_device(getattr(args, "device", "cuda"))
    if args.signal_demo:
        config = Config.get()
        config["sdrs"] = {"demo": SIGNAL_DEMO_CONFIG}
    failed = FeatureDetector().get_failed_requirements("core")
    if failed:
        raise SystemExit(f"missing core requirements: {failed}")
    # multi-host pod config (BASELINE #5): join the torch.distributed
    # cluster before any device program runs.  No-op single-host —
    # driven by OWRX_COORDINATOR/OWRX_NUM_PROCESSES/OWRX_PROCESS_ID or
    # the CLI flags (parallel/cluster.py).
    from openwebrx_tpu_torch.parallel.cluster import init_cluster
    cluster = init_cluster(getattr(args, "coordinator", None),
                           getattr(args, "num_processes", None),
                           getattr(args, "process_id", None),
                           device=SdrService.device)
    if cluster.num_processes > 1:
        logger.info("joined cluster: host %d/%d, %d local / %d global chips",
                    cluster.process_id, cluster.num_processes,
                    cluster.local_device_count, cluster.global_device_count)
    SdrService.load()
    warm_sources(SdrService.device)
    # boot ordering per reference owrx/__main__.py:138-158: sources →
    # background services → web server
    from openwebrx_tpu_torch.services.engine import Services
    Services.start()
    from openwebrx_tpu_torch.core.markers import Markers
    Markers.start()
    # database web agents (EIBI/receivers/repeaters): cache-file backed,
    # daily refresh when the deployment has network (reference GPS →
    # markers → agents boot order, owrx/__main__.py:143-154)
    if Config.get().get("web_agents_enabled", True):
        from openwebrx_tpu_torch.web.agents import register_marker_loaders
        register_marker_loaders()
    router = build_router()
    server = HttpServer(router, port=args.port, ssl_context=make_ssl_context())
    await server.start()
    scheme = "https" if server.ssl_context else "http"
    logger.info("openwebrx_tpu %s ready on %s port %d", __version__, scheme,
                args.port)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    await stop.wait()
    logger.info("shutting down")
    await server.stop()
    from openwebrx_tpu_torch.web.agents import stop_agents
    stop_agents()
    Markers.stop()
    Services.stop()
    SdrService.stop_all()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="openwebrx_tpu_torch",
        description="web SDR receiver on PyTorch (hand-written CUDA kernels "
                    "on the card); 'admin ...' manages web admin users")
    parser.add_argument("--port", type=int, default=8073)
    parser.add_argument("--signal-demo", action="store_true",
                        help="serve a synthetic multi-signal source")
    parser.add_argument("--sdrs", type=str, default=None,
                        help="JSON file or string with the sdrs config dict")
    parser.add_argument("--loglevel", default="INFO")
    parser.add_argument("--config", default=None,
                        help="settings file (default: settings.json in the "
                             "data directory)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the receiver (default cuda; "
                             "cpu runs the plain PyTorch path)")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host: coordinator host:port")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="multi-host: total host count")
    parser.add_argument("--process-id", type=int, default=None,
                        help="multi-host: this host's index")
    args = parser.parse_args(argv)
    logging.basicConfig(level=args.loglevel,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.config:
        Config._instance = Config._build(args.config)
    if args.sdrs:
        cfg = Config.get()
        if os.path.isfile(args.sdrs):
            with open(args.sdrs) as f:
                cfg["sdrs"] = json.load(f)
        else:
            cfg["sdrs"] = json.loads(args.sdrs)
    asyncio.run(main_async(args))


if __name__ == "__main__":
    main()
