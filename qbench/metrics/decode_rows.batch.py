"""Rows a decode step carries (core/scheduler.py's decode batch): the outputs each of the window's decode steps returned, averaged over those steps."""

from qbench import readers

LAYER = "scheduler"
UNIT = "rows"
SOURCE = "program_counter"
MOVES = "output_tok_s"
read = readers.decode_rows
