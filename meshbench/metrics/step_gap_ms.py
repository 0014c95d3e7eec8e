"""step_gap_ms: the train loop, device ms between one step's last phase
mark and the next step's start within an epoch (the step's row writes,
the step index and the time between two graph replays), the mean over
every train and light eval step of the window (meshbench/phases.py)."""
from meshbench.phases import step_gap_ms


def read(ctx):
    return step_gap_ms(ctx)
