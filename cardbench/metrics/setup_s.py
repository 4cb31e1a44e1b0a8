"""setup_s: seconds from the harness's first line to the window: imports,
the device context, the inputs drawn, the warm-up job (and, in a
checkout's first run, the kernel's build)."""


def read(reading):
    return reading.setup_s
