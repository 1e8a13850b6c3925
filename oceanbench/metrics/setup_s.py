"""setup_s: process start to the first timed tick (host clock): the interpreter, torch's
import, the kernels' load (their nvcc build in a first run), the state's init,
the graph captures and the warm-up ticks."""


def read(rec):
    return rec.setup_s
