"""One module a kind of traffic, found by the ``kind`` of a mix (see harness/traffic.py)."""
