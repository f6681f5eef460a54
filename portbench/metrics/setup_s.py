"""``setup_s`` (s): from the start of the process to the start of the
window: imports, the kernel library's build or load, the inputs made
from the seed, the warm-up fit. Host clock."""


def read(run):
    return run.setup_s
