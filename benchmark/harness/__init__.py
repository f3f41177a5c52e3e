"""The harness: lookup by name, traffic, drivers, trace reading and the output check."""
