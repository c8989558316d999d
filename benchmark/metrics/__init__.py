"""One reader a metric, found by the metric's name (see harness/spec.py)."""
