"""Measurement model and kernels: seconds the process spent loading the
port's CUDA kernel library, its nvcc build included where the checkout
had none yet, and in each entry point's first call (under CUDA's lazy
module loading, where its kernels reach the card): the program's counter
library_ns (`perfbench.program`)."""

from perfbench import program

LAYER = "measurement model and kernels"
UNIT = "s"
SOURCE = "program_counter"
MOVES = "setup_s"


def read(run):
    return program.seconds(run, "library_ns")
