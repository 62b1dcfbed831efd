"""Seconds from the process's start to the window's start: imports, planning, the
Trainer and its kernels (built on a checkout's first run, loaded after), the seed's
weights, and the first steps that warm every shape.  The seconds the program's side
of the check takes in between (norms of the moments and of the change) are left
out."""


def read(run):
    return run.setup_s
