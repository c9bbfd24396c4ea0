"""``setup_s``: seconds from the process's start to the first timed request
(imports, CUDA start, loading the kernel libraries, making the inputs, the
warm-up request), on the host clock."""


def read(run):
    return run.setup_s
