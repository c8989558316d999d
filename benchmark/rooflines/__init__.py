"""One file a kernel family: the work and bytes a call needs (see harness/trace.py)."""
