"""setup_s: seconds from the process's start to the first timed request:
the imports, the recordings and weights drawn on the card, the program's
loader, the input files, and the warm-up requests (which build the
kernels in a checkout's first run). Host clock."""


def read(run):
    return run.setup_s
