"""K4 (kernels/paged_attention.py): the least time of the traced steps' decode rows (qbench/roofline/paged_attention.py, their real contexts) over K4's device time in the trace."""

from qbench import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "output_tok_s"
read = readers.paged_attn_roofline
