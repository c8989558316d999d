"""K3 ``gather_planes`` (accel/gather.py, under every ``gather_cols``): rows
of a table gathered into (K, N) planes. A call reads the K selected
columns of the table, the N indices once and writes K x N floats; it does
no float arithmetic."""

MODULE = "pupiloptixlab_tpu_torch.accel.gather"


def planes(args, kwargs, out):
    table, idx = args[0], args[1]
    cols = args[2] if len(args) > 2 else kwargs.get("cols")
    k = table.shape[1] if cols is None else len(tuple(cols))
    n_bytes = table.shape[0] * k * table.element_size() \
        + idx.numel() * idx.element_size() + out.numel() * out.element_size()
    return n_bytes, 0


CALLS = {"gather_planes": planes}
