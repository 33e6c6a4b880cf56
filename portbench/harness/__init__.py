"""The benchmark's general code: it finds a cell's configuration, traffic
mix and metrics by name and runs them. Nothing here names a cell."""
