"""The W4A8 GEMMs (K2 and the routed K10, kernels/gemm.py): the least time of the traced steps' live rows (qbench/roofline/gemm.py) over those kernels' device time in the trace."""

from qbench import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "output_tok_s"
read = readers.gemm_roofline
