"""The whole step's share of the int8 peak: the model's ops in the traced stretch (qbench/roofline/model.py) over its length times 1979 TOP/s."""

from qbench import readers

LAYER = "whole step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "output_tok_s"
read = readers.mfu
