"""The port's operational scripts (the counterparts of the root ``scripts/``):
``bench_server`` (the HTTP server under concurrent clients),
``profile_serving`` and ``profile_train`` (per-op device-time tables)."""
