"""Discrete-event simulator of the continuous-batching engine's
scheduling: admission, block-pool accounting, token-budget chunked
ticks, QoS weighted queues and speculative acceptance, on virtual time
and with no device.

A copy of ``analytics_zoo_tpu/serving/sim/__init__.py`` (the package
is pinned module by module by ``tests/test_torch_serving_pins.py``).
It decides through the same pure functions of ``serving/policy.py``
that the port's ``ContinuousEngine`` calls, so it is the executable
specification of the engine's decisions: ``tests/test_torch_sim.py``
drives both from one request schedule and holds their admission,
chunk-grant and preemption sequences equal.  ``sim.replay`` replays a
flight bundle.  Standard library and ``serving/policy.py`` only.
"""

from ..policy import SCHEDULER_POLICY_VERSION  # noqa: F401
from .model import (AcceptanceModel, EngineConfig, EngineModel,  # noqa: F401
                    TimingModel, percentile, summarize)
from .replay import (SUPPORTED_SCHEMA_VERSIONS,  # noqa: F401
                     SchemaVersionError, load_bundle, replay_bundle)
from .trace import Request, diurnal_trace, poisson_trace  # noqa: F401

__all__ = [
    "AcceptanceModel", "EngineConfig", "EngineModel", "TimingModel",
    "Request", "poisson_trace", "diurnal_trace",
    "SUPPORTED_SCHEMA_VERSIONS", "SchemaVersionError",
    "load_bundle", "replay_bundle",
    "percentile", "summarize", "SCHEDULER_POLICY_VERSION",
]
