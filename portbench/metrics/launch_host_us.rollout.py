"""Host microseconds of one call of the kernel wrapper in a rollout
(``make_rows_step``'s step: checks, buffers, the ctypes launch): the
program's span ``vmas.rows.launch``, median over the traced calls' launches."""

from portbench import spans


def read(r):
    if r.get("kind") != "rollout":
        return None
    ms = spans.host_median_ms("vmas.rows.launch")
    return None if ms is None else 1e3 * ms
