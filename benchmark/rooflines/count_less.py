"""K4 ``count_less`` (accel/gather.py): the count of table entries below
each query, over one shared sorted table or, with ``rows=``, a row of a
table per query. A call reads the table, the queries (and the rows) once
and writes an int32 a query; its float operations are the compares of a
binary search, ceil(log2(T + 1)) a query."""

MODULE = "pupiloptixlab_tpu_torch.accel.gather"


def count(args, kwargs, out):
    table, q = args[0], args[1]
    rows = args[2] if len(args) > 2 else kwargs.get("rows")
    steps = max(int(table.shape[-1]).bit_length(), 1)
    ins = (table, q) if rows is None else (table, q, rows)
    n_bytes = sum(t.numel() * t.element_size() for t in ins) + out.numel() * out.element_size()
    return n_bytes, q.shape[0] * steps


CALLS = {"count_less": count}
