"""setup_s: from the process's start to the first timed work: imports, the
kernels' build (a first run only), the scene's load and flatten, and the
warm-up of the cell's own shapes."""


def read(rec):
    return rec["setup_s"]
