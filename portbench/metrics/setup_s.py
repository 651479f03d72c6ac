"""setup_s (s): host seconds from the process's start to the window's:
importing torch and the port, making the inputs on the device, building
the kernels (first run in a checkout only) and the warm-up with the
cell's own traffic."""


def read(outcome):
    return outcome.setup_s
