"""setup_s: seconds from the start of the process to the first timed solve:
torch's import, the card's context, the kernel library (its build on the
first run of a checkout), the input pool and the warm-up solves."""


def read(run):
    return run.setup_s
