"""eval_step_ms: the model, device ms per light eval step from its start
mark to its last (the loss, the pose error and the counterfactual), the
median over the window's evaluations of each one's mean (the program's
phase marks inside the step graphs, meshbench/phases.py)."""
from meshbench.phases import eval_step_ms


def read(ctx):
    return eval_step_ms(ctx)
