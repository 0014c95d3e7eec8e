"""forward_ms: the model, device ms per train step in its forward phase (the
batch gather through the loss), the median over the window's epochs of each
epoch's mean (the program's phase marks inside the step graphs,
meshbench/phases.py)."""
from meshbench.phases import train_phase_ms


def read(ctx):
    return train_phase_ms(ctx, "forward")
