"""wrapper_host_ms: host ms a traced solve inside the kernel wrappers'
opt.kernel.* spans (ops/), counted once where they nest (the union of
their intervals)."""

from portbench.benchlib.spans import host_ms_per_solve


def read(run):
    if run.trace is None:
        return None
    return host_ms_per_solve(run.trace,
                             lambda name: name.startswith("opt.kernel."))
