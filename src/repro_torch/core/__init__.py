"""Engine of the port: types, store, node steps, lock stage, metrics,
the cluster tick, workload lanes, the telemetry plane, the threefry PRNG,
the open-loop load generator, the declarative chaos suite, and
``ChainDist`` (one chain node per rank) with its collectives."""
from repro_torch.core.types import (  # noqa: F401
    N_OPCLASS,
    OPCLASS_NAMES,
    reply_op_class,
)
from repro_torch.core.telemetry import (  # noqa: F401
    RING_FIELDS,
    Telemetry,
    latency_bucket,
    record_latency,
    record_ring,
    record_trace,
)
from repro_torch.core.loadgen import (  # noqa: F401
    LoadGenState,
    draw_tick,
    followup_commits,
    gen_tick,
    make_loadgen,
    materialize_stream,
    zipf_cdf,
)
from repro_torch.core.chain import ChainDist, ChainSim, SimState  # noqa: F401
from repro_torch.core.chaos import (  # noqa: F401
    ChaosEvent,
    ChaosScenario,
    failure_storm,
    migration_wave,
    none_scenario,
    run_scenario,
    stale_clients,
)
