"""Operation and byte counts of the program's kernels, one file per kernel
family, and the card's peaks: the building blocks of a model family's
counts (qbench/families/). They belong to the yardstick: a later change
to the program does not move them."""
