"""Seconds from the benchmark's start to the window's: kernel library
build or load, data, index build, slab, warm-up."""


def read(run):
    return run.setup_s
