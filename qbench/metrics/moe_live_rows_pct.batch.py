"""The MoE layers' live rows over the rows their expert GEMMs compute, in the traced steps: 100 x the program's counter `moe_live_rows` (each token's top-k (token, expert) rows, T k) over `moe_expert_rows` (the masked loop's T x every expert, or the routed stream's P rows with its padding), both counted by models/llama.py's MoE dispatch and, for a replayed decode graph, recorded again at each replay. Low where the masked decode loop runs every expert for the k live ones."""

from qbench import counters

LAYER = "model"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "output_tok_s"
read = counters.share_pct("moe_live_rows", "moe_expert_rows")
