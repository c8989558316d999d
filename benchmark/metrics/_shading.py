"""Device seconds of the traced run's device part not spent in a hand
kernel (by the kernel names the family's calls launched): the plain
PyTorch work around them."""


def shading_s(trace):
    return trace["device_s"] - sum(f["device_s"] for f in trace["families"].values())
