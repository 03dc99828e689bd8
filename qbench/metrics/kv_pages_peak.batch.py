"""The KV cache's use (core/block_manager.py): the most pages any of the window's steps left in use, as a share of the cache's pages, which take 0.9 of the memory the weights leave. Beside memory_peak_bytes it says how much of the card the cell's work holds."""

from qbench import readers

LAYER = "scheduler"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "output_tok_s"
read = readers.kv_pages_peak
