"""``python -m analytics_zoo_tpu_torch.serving config.yaml``: start a
Cluster Serving job from its config file.

The port of ``analytics_zoo_tpu/serving/__main__.py``, the counterpart
of the reference's ``cluster-serving-start``: parse the config, load
the model artifact it names (``ClusterServing.from_config``: an
OpenVINO ``.xml`` or a pickled torch ``.pt``/``.pth``), start the
serving loop and block until SIGINT or SIGTERM, then stop cleanly.

``--embedded-broker`` runs the bundled RESP broker in-process; without
it the config's redis host:port must already be running.
``--http-port`` also starts the HTTP frontend (0 picks a free port,
printed in the banner).  ``--platform cpu`` loads the model onto the
CPU; the default is the card (``gpu``).  ``--trace PATH`` writes the
telemetry ring as Chrome trace-event JSON on shutdown.

The config file is YAML where PyYAML imports, else JSON
(``ServingConfig.from_yaml``).
"""

import argparse
import signal
import sys
import threading

_DEVICES = {"cpu": "cpu", "gpu": "cuda"}


def main(argv=None, block=True):
    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.serving",
        description="Start a Cluster Serving job from a config.yaml")
    ap.add_argument("config", help="path to config.yaml")
    ap.add_argument("--embedded-broker", action="store_true",
                    help="run the bundled RESP broker in-process")
    ap.add_argument("--http-port", type=int, default=None,
                    help="also start the HTTP frontend (ref: "
                         "FrontEndApp) on this port (0 = an ephemeral "
                         "port, printed in the banner)")
    ap.add_argument("--platform", choices=sorted(_DEVICES), default="gpu",
                    help="where the model runs (default gpu, the card)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="on shutdown, dump the telemetry event ring "
                         "as Chrome trace-event JSON to PATH (load at "
                         "https://ui.perfetto.dev); the same data is "
                         "live at GET /trace while serving")
    args = ap.parse_args(argv)

    import torch

    from analytics_zoo_tpu_torch.serving import ClusterServing

    if args.platform == "gpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --platform "
                           "cpu to serve on the CPU")

    # default signal behavior DURING assembly (a hung model load or
    # broker connect must stay killable with Ctrl-C/SIGTERM); graceful
    # handlers go in after start() but BEFORE the banner, so a
    # supervisor signalling the instant it sees the banner still gets a
    # clean shutdown rather than the SIGTERM default
    serving = ClusterServing.from_config(
        args.config, embedded_broker=args.embedded_broker,
        device=_DEVICES[args.platform]).start()
    frontend = None
    if args.http_port is not None:
        from analytics_zoo_tpu_torch.serving import HttpFrontend

        try:
            frontend = HttpFrontend(
                redis_host=serving.config.redis_host,
                redis_port=serving.port, http_port=args.http_port,
                serving=serving).start()
        except BaseException:
            # a bind failure (port in use) must not abandon the already-
            # started serving loop / broker
            serving.stop()
            raise
    stop = threading.Event()
    banner = (f"serving up on {serving.config.redis_host}:"
              f"{serving.port}"
              + (f", http on :{frontend.port}" if frontend else "")
              + " (Ctrl-C to stop)")

    def shutdown():
        if frontend is not None:
            frontend.stop()
        serving.stop()
        if args.trace:
            serving.telemetry.dump_trace(args.trace)
            print(f"trace written to {args.trace}", flush=True)

    if not block:       # tests drive the assembled stack directly
        return serving, frontend, shutdown
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    print(banner, flush=True)
    stop.wait()
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
