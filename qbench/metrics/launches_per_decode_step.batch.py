"""The port's kernel launches a decode step makes (kernels/_build.LAUNCHES; library calls are not counted), summed over the window's decode steps, over their count. An eager step's are counted where each wrapper launches; a step that replays a captured CUDA graph (worker/model_runner.py `DecodeGraph`) adds back the launches its capture recorded, so its count is the capture's record, not a count of launches the replay made."""

from qbench import readers

LAYER = "model"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "output_tok_s"
read = readers.launches_per_decode_step
