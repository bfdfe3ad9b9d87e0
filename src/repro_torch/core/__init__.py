"""Engine of the port: types, store, node steps, lock stage, metrics,
the cluster tick and workload lanes."""
