"""The general parts of the benchmark: finding a cell's files, the closed
loop, the profiler's summary, the work bound and the output check."""
