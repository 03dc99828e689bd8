"""Output tokens that steps inside the window returned, over the window's
seconds. A token counts when the step that produced it returns."""

UNIT = "tokens/s"
SOURCE = "host_clock"


def read(run):
    return sum(s.new_tokens for s in run.window) / (run.t1 - run.t0)
