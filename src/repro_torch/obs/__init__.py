"""Host-side readers of the port's device-side telemetry plane: the
``TelemetryHub`` snapshots the telemetry leaves off a running engine
(never the reply-log body), turns histograms into percentiles and
snapshot pairs into rates, and writes JSONL and a summary table."""
from repro_torch.obs.hub import (  # noqa: F401
    TelemetryHub,
    TelemetrySnapshot,
    tail_percentiles,
)
