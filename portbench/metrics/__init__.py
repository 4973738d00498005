"""Per-layer metric readers: `<name>.py` holds `read(facts)`, which
returns the metric (a float) or None where the run gives it nothing to
read. `facts` is `harness.Facts`."""
