"""gcn_backward_ms: the model, device ms per train step from the
``forward`` mark to the joint model's ``gcn_grad`` mark, stamped where the
backward's gradient reaches the GCN's input: the loss's and the GCN's
backward, a part of backward_ms. The median over the window's epochs of
each epoch's mean (the sub-phase ``gcn_backward`` of the program's phase
records, meshbench/phases.py). A program or a model without the mark
leaves no such sub-phase, and the reader returns None."""
import numpy as np

from meshbench.phases import window


def read(ctx):
    recs = window(ctx)
    per_epoch = [rec["sub_phases"]["gcn_backward"].mean()
                 for rec in (recs or {}).get("train", [])
                 if "gcn_backward" in rec.get("sub_phases", {})]
    return float(np.median(per_epoch)) if per_epoch else None
