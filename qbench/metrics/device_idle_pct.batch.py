"""100 x (1 - the union of the device's operations over the traced stretch), from torch.profiler."""

from qbench import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "output_tok_s"
read = readers.device_idle_pct
