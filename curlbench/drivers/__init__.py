"""Traffic drivers, one file per kind of traffic (`harness` loads them by name)."""
