"""setup_s (s, host clock): from the process's start to the first solve of
the window: imports, the kernels' libraries (built on a checkout's first
run), the inputs, the operators, the warm-up solves (the first of which
captures the program's graphs)."""


def read(run):
    return run.setup_s
