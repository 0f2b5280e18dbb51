"""The port's serving stack: the continuous-batching engine, the paged
KV block pool, Cluster Serving (RESP broker, queues, server, HTTP
frontend), telemetry, the flight recorder and the QoS front-door
pieces, with the reference's exports.  Importing it needs neither CUDA
nor JAX."""

from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine
from analytics_zoo_tpu_torch.serving.flight import (AnomalyMonitor,
                                                    FlightRecorder,
                                                    JsonLogFormatter,
                                                    RingLogHandler,
                                                    SloPolicy,
                                                    SloWatchdog,
                                                    dump_bundle,
                                                    install_flight_logging,
                                                    prune_bundles,
                                                    request_uri_context)
from analytics_zoo_tpu_torch.serving.frontdoor import (PRIORITIES,
                                                       QosPolicy,
                                                       TokenEmitter,
                                                       WeightedWaitQueue,
                                                       normalize_request_id,
                                                       retry_after_s)
from analytics_zoo_tpu_torch.serving.paged_cache import BlockPool
from analytics_zoo_tpu_torch.serving.queues import (BacklogFull,
                                                    InputQueue,
                                                    OutputQueue)
from analytics_zoo_tpu_torch.serving.resp import RespClient, RespServer
from analytics_zoo_tpu_torch.serving.server import (ClusterServing,
                                                    ServingConfig)
from analytics_zoo_tpu_torch.serving.http_frontend import HttpFrontend
from analytics_zoo_tpu_torch.serving.telemetry import (
    MetricsRegistry, Telemetry, WindowHistogram, render_prometheus,
    validate_chrome_trace)

__all__ = ["ContinuousEngine", "BlockPool", "InputQueue", "OutputQueue",
           "RespClient", "RespServer", "ClusterServing", "ServingConfig",
           "HttpFrontend", "MetricsRegistry", "Telemetry",
           "WindowHistogram", "render_prometheus",
           "validate_chrome_trace",
           "BacklogFull", "PRIORITIES", "QosPolicy", "TokenEmitter",
           "WeightedWaitQueue", "retry_after_s",
           "FlightRecorder", "SloPolicy", "SloWatchdog", "AnomalyMonitor",
           "dump_bundle", "prune_bundles", "JsonLogFormatter",
           "RingLogHandler", "install_flight_logging",
           "request_uri_context", "normalize_request_id"]
