"""Host seconds of the kernels' load in set-up (each library's first load:
the sources' hash, the nvcc build where the checkout has none, dlopen and
the binding): the program's span ``vmas.kernels.load``, summed over the
process."""

from portbench import spans


def read(r):
    return spans.host_total_s("vmas.kernels.load")
