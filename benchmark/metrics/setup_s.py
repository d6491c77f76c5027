"""setup_s: process start until the window opens: imports, the device's
start, the weights and the request pool made from the seed, the kernel
libraries loaded (built on a checkout's first run) and one warm-up
request."""


def read(run):
    return run.setup_s
