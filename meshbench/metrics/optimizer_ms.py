"""optimizer_ms: the model, device ms per train step in its optimizer phase
(the Adam update), the median over the window's epochs of each epoch's mean
(the program's phase marks inside the step graphs, meshbench/phases.py)."""
from meshbench.phases import train_phase_ms


def read(ctx):
    return train_phase_ms(ctx, "optimizer")
