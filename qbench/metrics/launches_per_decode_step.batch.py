"""The port's kernel launches a decode step makes (kernels/_build.LAUNCHES, counted where each wrapper launches; library calls are not counted), summed over the window's decode steps, over their count."""

from qbench import readers

LAYER = "model"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "output_tok_s"
read = readers.launches_per_decode_step
